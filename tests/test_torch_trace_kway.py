"""The port's trace under the K-way drain, against the JAX engine's.

Tolerance 0, on the batch of ``tests/test_torch_trace.py`` (all ten
policies on flat, dynamic-fleet and workflow instances).  At
``drain_k=8`` the port's transition rows, snapshots and metrics counts
must equal the JAX engine's with its Pallas kernels on (interpret
mode); at ``drain_k`` 2 and 8 the port's trace must equal its own
one-decision drain's, and tracing must not perturb the run.  The JAX
``drain_k=2`` trace is held in ``tests/test_torch_metrics.py``; each
K-way compile of the reference takes some 20 s.
"""
from __future__ import annotations

import pytest
from test_torch_drain_kway import assert_bitwise, jax_run, port_run
from test_torch_trace import (assert_counts_equal, assert_trace_equal,
                              traced)

from repro_torch.core import engine as TE

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def batch():
    from test_torch_drain_kway import mixed_batch
    return mixed_batch()


@pytest.fixture(scope="module")
def k1(batch):
    return port_run(batch, traced()[1])


def test_kway8_trace_matches_jax(batch):
    jp, tp = traced(drain_k=8)
    sj = jax_run(batch, jp._replace(pallas=True))
    st = port_run(batch, tp)
    n = st.n_events.shape[0]
    assert_trace_equal(sj, st, range(n), "k=8 pallas")
    assert_counts_equal(sj, st, "k=8 pallas")
    assert_bitwise(sj, st, "k=8 pallas")


@pytest.mark.parametrize("k", [2, 8])
def test_kway_trace_equals_sequential(batch, k1, k):
    stats, plain_stats = TE.RunStats(), TE.RunStats()
    st = port_run(batch, traced(drain_k=k)[1], stats)
    plain = port_run(batch, TE.SimParams(lcap=3, drain_k=k), plain_stats)
    assert_trace_equal(k1, st, range(st.n_events.shape[0]), f"k={k}")
    assert_counts_equal(k1, st, f"k={k}")
    assert_bitwise(st, plain, f"k={k} on vs off")
    assert stats == plain_stats
