"""The port's K-way drain against the JAX engine's, second executable.

``tests/test_torch_drain_kway.py`` holds the port's ``drain_k=2`` and
``drain_k=8`` to its one-decision drain and to the JAX ``drain_k=8``;
here, on the same batch (all ten policies on flat, dynamic-fleet and
workflow instances), the port's ``drain_k=2`` must be bitwise the JAX
``drain_k=2`` and its ``drain_k=8`` the JAX ``drain_k=8`` with the
Pallas kernels on (interpret mode).  Each K-way compile of the reference
takes some 20 s, hence a file of their own.
"""
from __future__ import annotations

import pytest
from test_torch_drain_kway import (assert_bitwise, jax_run, mixed_batch,
                                   port_run)

from repro.core import engine as E
from repro_torch.core import engine as TE

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def batch():
    return mixed_batch()


@pytest.mark.parametrize("k,pallas", [(2, False), (8, True)])
def test_kway_matches_jax(batch, k, pallas):
    want = jax_run(batch, E.SimParams(lcap=3, drain_k=k, pallas=pallas))
    assert_bitwise(want, port_run(batch, TE.SimParams(lcap=3, drain_k=k)),
                   f"k={k} pallas={pallas}")
