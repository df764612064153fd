"""Parity of the PyTorch port's engine with the JAX engine and the oracle.

The same numpy inputs (``conftest.make_instance``) go through
``repro.core.engine.run_sweep`` and ``repro_torch.core.engine.run_sweep``
as one batch holding every ported policy.  Tolerance 0: status, machine,
seq, t_start, t_end, busy_until, active_time and energy must be bitwise
equal, with the reference's Pallas kernels off and on (interpret mode);
the port's kernel wrappers run their plain versions on the CPU.
Against the plain-Python oracle ``simulate_ref`` (float64) the floats use
the oracle suite's own tolerance (``tests/test_engine_vs_ref.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_instance

from repro.core import engine as E
from repro.core import ref_engine as R
from repro.core import schedulers as P
from repro_torch import interop, resolve_device
from repro_torch.core import engine as TE
from repro_torch.core import schedulers as TP
from repro_torch.core import state as TS
from repro_torch.core.eet import EETTable
from repro_torch.core.workload import Workload

pytestmark = pytest.mark.torch

POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")
SEEDS = (42, 7)
FIELDS = (("tasks", "status"), ("tasks", "machine"), ("tasks", "seq"),
          ("tasks", "t_start"), ("tasks", "t_end"),
          ("machines", "busy_until"), ("machines", "active_time"),
          ("machines", "energy"), (None, "n_events"), (None, "time"))


def _field(st, group, name):
    return getattr(st if group is None else getattr(st, group), name)


def _stack_instances(make, policies=POLICIES, seeds=SEEDS):
    """One JAX replica batch: every policy on every seed's instance."""
    reps = []
    for seed in seeds:
        eet, power, wl, mtype = make(seed)
        tables = E.make_tables(eet, power, wl.n_tasks)
        for p in policies:
            reps.append((wl.to_task_table(), jnp.asarray(mtype, jnp.int32),
                         tables, jnp.int32(P.POLICY_IDS[p])))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *reps)


def _run_port(batch):
    reps = interop.replicas_from_numpy(*batch, device="cpu")
    return TE.run_sweep(reps.tasks, reps.mtype, reps.tables,
                        reps.policy_ids)


@pytest.fixture(scope="module")
def conftest_batch():
    return _stack_instances(make_instance)


@pytest.fixture(scope="module")
def jax_states(conftest_batch):
    return {pallas: E.run_sweep(*conftest_batch, E.SimParams(pallas=pallas))
            for pallas in (False, True)}


@pytest.fixture(scope="module")
def port_state(conftest_batch):
    return _run_port(conftest_batch)


def _rows_of(policy, seeds=SEEDS):
    return [i * len(POLICIES) + POLICIES.index(policy)
            for i in range(len(seeds))]


def _assert_bitwise(sj, st, rows, what):
    for group, name in FIELDS:
        a = np.asarray(_field(sj, group, name))[rows]
        b = _field(st, group, name)[rows].numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(
            a.view(np.int32) if a.dtype == np.float32 else a,
            b.view(np.int32) if b.dtype == np.float32 else b,
            err_msg=f"{name} {what}")


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_run_sweep_bitwise_matches_jax(jax_states, port_state, policy,
                                       pallas):
    _assert_bitwise(jax_states[pallas], port_state, _rows_of(policy),
                    f"policy={policy} pallas={pallas}")


@pytest.mark.parametrize("policy", POLICIES)
def test_run_sweep_matches_oracle(port_state, policy):
    """The port against the plain-Python oracle, with the oracle suite's
    assertions (statuses and machines exact, floats to its tolerance)."""
    st = port_state
    for i, seed in enumerate(SEEDS):
        eet, power, wl, mtype = make_instance(seed)
        ref = R.simulate_ref(wl.arrival, wl.type_id, wl.deadline, eet.eet,
                             power, mtype, policy=policy)
        r = i * len(POLICIES) + POLICIES.index(policy)
        np.testing.assert_array_equal(st.tasks.status[r].numpy(), ref.status)
        np.testing.assert_array_equal(st.tasks.machine[r].numpy(),
                                      ref.machine)
        np.testing.assert_allclose(st.tasks.t_start[r].numpy(), ref.t_start,
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(st.tasks.t_end[r].numpy(), ref.t_end,
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(st.machines.energy[r].numpy(),
                                   ref.active_energy, rtol=1e-4, atol=1e-2)


def _wide_instance(seed):
    """100 tasks on 6 machines — past the 32-wide summation windows and
    the vector width — with exactly representable energy products (unit
    noise, powers-of-two power table): the one input family on which the
    reference's own float bits do not depend on where its compiler fuses
    multiply-adds (ROADMAP.md, queue C)."""
    eet, power, wl, mtype = make_instance(seed, n_tasks=100, n_machines=6,
                                          rate=6.0)
    return eet, np.exp2(np.round(np.log2(power))).astype(np.float32), wl, \
        mtype


WIDE_SEEDS = (3, 4)


@pytest.fixture(scope="module")
def wide_states():
    # 20 replicas x 100 tasks x 6 machines: every policy on two seeds
    batch = _stack_instances(_wide_instance, seeds=WIDE_SEEDS)
    return E.run_sweep(*batch), _run_port(batch)


@pytest.mark.parametrize("policy", POLICIES)
def test_wide_instance_bitwise(wide_states, policy):
    """The reference's plain path against the port (plain versions of
    the kernels on the CPU), past the 32-wide summation windows."""
    sj, st = wide_states
    _assert_bitwise(sj, st, _rows_of(policy, WIDE_SEEDS),
                    f"policy={policy}")


@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_single_replica_matches_jax(policy):
    eet, power, wl, mtype = make_instance(42)
    sj = E.simulate(wl, eet, power, mtype, policy=policy, lcap=3)
    st = TE.simulate(Workload(wl.arrival, wl.type_id, wl.deadline),
                     EETTable(eet.eet), power, mtype, policy=policy,
                     lcap=3, device="cpu")
    for group, name in FIELDS:
        a = np.asarray(_field(sj, group, name))
        b = _field(st, group, name)[0].numpy()
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_run_sweep_calls_every_kernel_wrapper(conftest_batch, monkeypatch):
    """The engine reaches its reductions only through the kernel
    wrappers (which pick the kernel or the plain version by device), so
    on the card the main path launches every kernel."""
    from repro_torch.kernels import sched_argmin as TK
    calls = dict.fromkeys(TK.NAMES, 0)

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    for name in TK.NAMES:
        monkeypatch.setattr(TK, name, counting(name, getattr(TK, name)))
    _run_port(conftest_batch)
    assert all(calls.values()), calls


@pytest.mark.parametrize("policy", ["maxmin", "mlp", "linear"])
def test_unported_policies_raise(policy):
    """The policies that once refused to run (maxmin, then the learned
    mlp and linear) run to the end now; the learned ones, with the
    reference's random weights carried across, bitwise the JAX
    ``simulate`` on every state field (tolerance 0)."""
    eet, power, wl, mtype = make_instance(1, n_tasks=8)
    pp = None
    if policy != "maxmin":
        from repro.core import neural as JN
        pp = JN.init_params(3)
    st = TE.simulate(Workload(wl.arrival, wl.type_id, wl.deadline),
                     EETTable(eet.eet), power, mtype, policy=policy,
                     device="cpu", policy_params=None if pp is None else
                     interop.policy_params_from_numpy(
                         JN.params_to_numpy(pp), "cpu"))
    assert bool((st.tasks.status >= TS.COMPLETED).all())
    if pp is not None:
        sj = E.simulate(wl, eet, power, mtype, policy=policy,
                        policy_params=pp)
        _assert_bitwise(jax.tree.map(lambda x: x[None], sj), st, [0],
                        f"policy={policy}")


def test_policy_ids_match_reference():
    for name in POLICIES:
        assert TP.POLICY_IDS[name] == P.POLICY_IDS[name], name
    for name in TP.POLICY_NAMES:
        if name in P.POLICY_IDS:
            assert TP.POLICY_IDS[name] == P.POLICY_IDS[name], name


def test_reference_fma_contraction_fault():
    """Queue C fault, on the reference side: on inputs whose products
    round (lognormal noise, random power table), XLA's CPU compiler fuses
    ``time + eet * noise`` and the energy charge into one multiply-add in
    some loop positions and not in others, so the JAX engine's own
    single-replica ``run_sim`` and batched ``run_sweep`` disagree in the
    last bits of t_end.  Decisions do not move: the port matches the
    batched reference exactly on every integer field, and on the floats
    within the oracle suite's tolerance."""
    from repro.launch import experiment as X
    nine = tuple(p for p in POLICIES if p != "maxmin")
    spec = X.ExperimentSpec(18, X.FleetAxis(6), X.WorkloadAxis(100),
                            policy=X.PolicyAxis(nine), seed=3)
    reps = X.normalize(spec)
    batch = (reps.tasks, reps.mtype, reps.tables, reps.policy_ids)
    sj = E.run_sweep(*batch)
    single = [E.run_sim(*jax.tree.map(lambda x: x[i], batch))
              for i in range(spec.n_replicas)]
    t_end_single = np.stack([np.asarray(s.tasks.t_end) for s in single])
    assert (t_end_single != np.asarray(sj.tasks.t_end)).any()
    st = _run_port(batch)
    for name in ("status", "machine", "seq"):
        np.testing.assert_array_equal(getattr(st.tasks, name).numpy(),
                                      np.asarray(getattr(sj.tasks, name)))
    for name in ("t_start", "t_end"):
        np.testing.assert_allclose(getattr(st.tasks, name).numpy(),
                                   np.asarray(getattr(sj.tasks, name)),
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(st.machines.energy.numpy(),
                               np.asarray(sj.machines.energy),
                               rtol=1e-4, atol=1e-2)


def test_cuda_default_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
