"""The port's chunked Monte-Carlo path (``launch/chunked.py``) against the
JAX package.

``normalize_chunk`` must draw bit-equal chunks, the slices of both
packages' ``normalize``; ``_decompose`` and ``aggregate_metrics`` must
give the reference's ``SweepAgg`` array for array (``a``, ``b``,
``counts``, ``vmin``, ``vmax``, ``hist``), signed zeros, subnormals,
infinities and NaN included; and ``run_experiment(spec, chunk=C).agg``
must be bitwise the JAX one at the sizes of ``tests/test_chunked.py``.
The engines agree bitwise on replicas whose products are exact (unit
noise, powers-of-two power tables and DVFS multipliers), so the runs use
those.  With a dynamic fleet the reference's compiled sweep sums three
columns over machines in a vectorized order (ROADMAP.md, queue C); there
those columns are held bitwise against the reference's summary evaluated
outside its compiled sweep, folded by its ``aggregate_metrics``.  Port
only: the aggregate is bitwise invariant to chunk size, remainder,
order and ``merge``; ``keep_replicas`` gives back the monolithic
columns; the telemetry spans of a run have the reference's names,
nesting and order; the host memory of a chunked run tracks the chunk.
"""
from __future__ import annotations

import dataclasses
import math
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import telemetry as JTL
from repro.launch import chunked as JCH
from repro.launch import experiment as X
from repro_torch import interop
from repro_torch.core import schedulers as TP
from repro_torch.core import telemetry as TTL
from repro_torch.launch import chunked as TCH
from repro_torch.launch import experiment as TX

pytestmark = pytest.mark.torch

# summed over machines inside a fused reduction of the compiled sweep,
# in an order XLA picks when it vectorizes (queue C)
VECTORIZED = ("availability", "idle_energy", "energy")
PARTS = ("a", "b", "hist", "vmin", "vmax")
PORTED = list(TP.POLICY_NAMES)     # every policy, the learned included


# ---------------------------------------------------------------------------
# The specs of tests/test_chunked.py, in either package
# ---------------------------------------------------------------------------
def flat_spec(lib, n=96, n_tasks=16, seed=7, **kw):
    return lib.ExperimentSpec(
        n, lib.FleetAxis(4, 2), lib.WorkloadAxis(n_tasks, 3),
        policy=lib.PolicyAxis(("mct", "ee_mct", "minmin")), seed=seed, **kw)


def scenario_spec(lib, n=96, n_tasks=16, seed=3):
    return lib.ExperimentSpec(
        n, lib.FleetAxis(4, 2), lib.WorkloadAxis(n_tasks, 3),
        scenario=lib.ScenarioAxis((0.0, 0.1), ("nominal", "powersave"),
                                  spot_frac=0.5),
        policy=lib.PolicyAxis(("mct", "ee_mct")), seed=seed)


def streaming_spec(lib, n=48, seed=5):
    return lib.ExperimentSpec(
        n, lib.FleetAxis(4, 2), lib.WorkloadAxis(16, 3, streaming=16),
        policy=lib.PolicyAxis(("mct", "rr")), seed=seed)


def workflow_spec(lib, n=36, seed=11):
    return lib.ExperimentSpec(
        n, lib.FleetAxis(4, 2),
        lib.WorkloadAxis(12, 3, shapes=("chain", "fork_join")),
        policy=lib.PolicyAxis(("heft", "mct")), seed=seed)


SPECS = {
    "flat": flat_spec,
    "scenario": scenario_spec,
    "streaming": streaming_spec,
    "workflow": workflow_spec,
    "tail_metrics": lambda lib: flat_spec(lib, n=48, metrics=True),
}
# the port's chunk size with a remainder for each spec (the workflow's
# 15 splits a cell of its two paired policies); the JAX runs take two
# equal chunks, one compile each, as their aggregate does not depend on
# the chunk size (tests/test_chunked.py)
CHUNK = {"flat": 40, "scenario": 40, "streaming": 20, "workflow": 15,
         "tail_metrics": 20}


def assert_aggs_bitwise_equal(x, y, columns=None):
    """``x``, ``y``: SweepAggs of either package (numpy fields both)."""
    assert x.policies == y.policies
    assert tuple(x.spec) == tuple(y.spec)
    assert x.columns == y.columns
    np.testing.assert_array_equal(x.counts, y.counts)
    assert x.counts.dtype == y.counts.dtype == np.int64
    for k in columns or x.columns:
        for part in PARTS:
            a, b = getattr(x, part)[k], getattr(y, part)[k]
            assert a.dtype == b.dtype and a.shape == b.shape, (k, part)
            assert a.tobytes() == b.tobytes(), f"column {k} part {part}"


def _pow2(x):
    return jnp.exp2(jnp.round(jnp.log2(x)))


def _exact(reps):
    """Replicas whose products are exact: unit noise, powers-of-two
    power tables and DVFS multipliers."""
    tb, dyn = reps.tables, reps.dynamics
    reps = reps._replace(tables=dataclasses.replace(
        tb, power=_pow2(tb.power), noise=jnp.ones_like(tb.noise)))
    if dyn is not None:
        reps = reps._replace(dynamics=dataclasses.replace(
            dyn, speed=_pow2(dyn.speed), power_scale=_pow2(dyn.power_scale)))
    return reps


def _port_reps(reps):
    return interop.replicas_from_numpy(reps.tasks, reps.mtype, reps.tables,
                                       reps.policy_ids, reps.dynamics,
                                       reps.parents, device="cpu")


def _records(log) -> list[dict]:
    return [r for r in log if r["kind"] == "span"]


@pytest.fixture(scope="module", params=sorted(SPECS))
def runs(request, tmp_path_factory):
    """One spec's exact-product replicas through both packages' chunked
    chunked runs at two equal chunks with telemetry on, and through the
    port's at ``CHUNK``.  Returns (kind, JAX result, port result at
    ``CHUNK``, JAX span records, port span records, JAX agg of the
    summary evaluated outside the compiled sweep or None)."""
    kind = request.param
    jspec, tspec = SPECS[kind](X), SPECS[kind](TX)
    half = jspec.n_replicas // 2
    reps = _exact(X.normalize(jspec))
    treps = _port_reps(reps)
    out = []
    for lib, run in ((JTL, lambda: X.run_experiment(
            jspec, chunk=half, replicas=reps)),
            (TTL, lambda: TX.run_experiment(
                tspec, chunk=half, replicas=treps, device="cpu"))):
        log = lib.enable(str(tmp_path_factory.mktemp(kind)))
        try:
            res = run()
        finally:
            lib.disable()
        out.append((res, _records(lib.read_jsonl(log.path))))
    (jres, jrecs), (_, trecs) = out
    tres = TX.run_experiment(tspec, chunk=CHUNK[kind], replicas=treps,
                             device="cpu")
    eager = None
    if reps.dynamics is not None:
        sj = JE.run_sweep(reps.tasks, reps.mtype, reps.tables,
                          reps.policy_ids, JE.SimParams(), reps.dynamics,
                          None, reps.parents)
        cols = jax.vmap(X.summarize_replica)(sj, reps.tables, reps.dynamics)
        eager = JCH.aggregate_metrics(cols, reps.policy_ids,
                                      jspec.policy.policies)
    return kind, jres, tres, jrecs, trecs, eager


# ---------------------------------------------------------------------------
# normalize_chunk
# ---------------------------------------------------------------------------
def _fields(reps) -> dict:
    """The drawn inputs of either package's Replicas, as numpy arrays."""
    out = {"arrival": reps.tasks.arrival, "type_id": reps.tasks.type_id,
           "deadline": reps.tasks.deadline, "mtype": reps.mtype,
           "policy_ids": reps.policy_ids, "parents": reps.parents}
    for f in ("eet", "power", "noise", "rank"):
        out[f] = getattr(reps.tables, f)
    for f in ("speed", "power_scale", "down_start", "down_end", "kill"):
        out[f] = None if reps.dynamics is None \
            else getattr(reps.dynamics, f)
    return {k: None if v is None else np.asarray(v) for k, v in out.items()}


def _same_fields(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, (what, k)
            continue
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        assert a.tobytes() == b.tobytes(), (what, k)


@pytest.mark.parametrize("kind", ["flat", "scenario", "workflow",
                                  "streaming"])
def test_normalize_chunk_bitwise_jax_and_sliced_normalize(kind):
    """Against the JAX ``normalize_chunk`` and the slices of the port's
    own ``normalize``; ``(7, 23)`` starts inside a paired workflow cell,
    and every workflow chunk pads to the grid's widest in-degree."""
    jspec, tspec = SPECS[kind](X), SPECS[kind](TX)
    full = _fields(TX.normalize(tspec, device="cpu"))
    n = tspec.n_replicas
    for lo, hi in ((0, 5), (5, n), (n - 1, n), (0, n), (7, 23)):
        got = _fields(TX.normalize_chunk(tspec, lo, hi, device="cpu"))
        _same_fields(got, _fields(X.normalize_chunk(jspec, lo, hi)),
                     f"{kind} [{lo}, {hi}) against JAX")
        _same_fields(got, {k: None if v is None else v[lo:hi]
                           for k, v in full.items()},
                     f"{kind} [{lo}, {hi}) against the slice")
    if kind == "workflow":
        assert TX._workflow_kmax(tspec) == X._workflow_kmax(jspec) \
            == full["parents"].shape[2]


def test_normalize_chunk_range_errors():
    jspec, tspec = flat_spec(X, n=8), flat_spec(TX, n=8)
    for lo, hi in ((-1, 4), (4, 4), (5, 3), (0, 9)):
        with pytest.raises(ValueError, match="chunk") as want:
            X.normalize_chunk(jspec, lo, hi)
        with pytest.raises(ValueError, match="chunk") as got:
            TX.normalize_chunk(tspec, lo, hi, device="cpu")
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The exact fold
# ---------------------------------------------------------------------------
F32 = np.finfo(np.float32)
EDGES = np.array([0.0, -0.0, F32.smallest_subnormal,
                  -3 * F32.smallest_subnormal,
                  F32.tiny * 0.5, -F32.tiny, 1.0, -3.5, F32.max, -F32.max,
                  np.inf, -np.inf], np.float32)


def test_decompose_edge_values():
    x = np.concatenate([EDGES, np.random.default_rng(0).lognormal(
        0, 6, 64).astype(np.float32)])
    jm, jb = JCH._decompose(jnp.asarray(x))
    tm, tb = TCH._decompose(torch.from_numpy(x))
    for a, b in ((jm, tm), (jb, tb)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    finite = np.isfinite(x)
    mant, ebin = tm.numpy().astype(np.float64), tb.numpy()
    np.testing.assert_array_equal(
        np.ldexp(mant, ebin - 150)[finite], x[finite].astype(np.float64))
    assert (ebin[np.isinf(x)] == 255).all()
    assert ebin[2] == ebin[3] == 1              # subnormals share bin 1


def _edge_metrics():
    """A seeded metrics dict over three policies with the edge values,
    a NaN, an int column and a column of zeros of both signs."""
    rng = np.random.default_rng(3)
    n = 90
    x = rng.lognormal(0, 4, n).astype(np.float32)
    x[::7] *= -1
    x[:EDGES.size] = EDGES
    y = rng.normal(0, 1e-40, n).astype(np.float32)
    y[5] = np.nan
    z = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
    z[rng.random(n) < 0.3] = 1.0
    ids = np.array([TP.POLICY_IDS[p] for p in ("mct", "ee_mct", "minmin")]
                   )[rng.integers(0, 3, n)].astype(np.int32)
    cols = {"x": x, "y": y, "z": z,
            "n": rng.integers(-5, 2**30, n).astype(np.int32)}
    return cols, ids


POLICIES3 = ("mct", "ee_mct", "minmin")


def _port_agg(cols, ids):
    return TCH.aggregate_metrics({k: torch.from_numpy(v)
                                  for k, v in cols.items()},
                                 torch.from_numpy(ids), POLICIES3)


def test_aggregate_metrics_edge_values_bitwise_jax():
    cols, ids = _edge_metrics()
    want = JCH.aggregate_metrics({k: jnp.asarray(v) for k, v in cols.items()},
                                 ids, POLICIES3)
    got = _port_agg(cols, ids)
    assert_aggs_bitwise_equal(got, want)
    assert np.isnan(got.vmin["y"]).any() and np.isnan(got.vmax["y"]).any()
    assert np.signbit(got.vmin["z"]).any()
    np.testing.assert_equal(got.summary(), want.summary())
    for pol in POLICIES3:
        np.testing.assert_equal(got.summary(pol), want.summary(pol))
        for q in (0.0, 12.5, 50.0, 99.0, 100.0):
            assert got.quantile("x", q, pol) == want.quantile("x", q, pol)
    np.testing.assert_equal(got.by_policy(("x", "n", "z")),
                            want.by_policy(("x", "n", "z")))
    # two equal halves: one JAX compile of the fold for both
    half = {k: v[:45] for k, v in cols.items()}
    rest = {k: v[45:] for k, v in cols.items()}
    merged = _port_agg(half, ids[:45]).merge(_port_agg(rest, ids[45:]))
    assert_aggs_bitwise_equal(merged, got)
    jmerged = JCH.aggregate_metrics(
        {k: jnp.asarray(v) for k, v in half.items()}, ids[:45], POLICIES3
    ).merge(JCH.aggregate_metrics(
        {k: jnp.asarray(v) for k, v in rest.items()}, ids[45:], POLICIES3))
    assert_aggs_bitwise_equal(merged, jmerged)


def _fold_values(vals: np.ndarray):
    ids = torch.full((len(vals),), TP.POLICY_IDS["mct"], dtype=torch.int32)
    return TCH.aggregate_metrics({"x": torch.from_numpy(vals)}, ids,
                                 ("mct",))


def test_fold_partition_and_order_invariance():
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.lognormal(0, 4, 200), -rng.lognormal(0, 4, 100),
        np.zeros(8), rng.normal(0, 1e-40, 16)]).astype(np.float32)
    whole = _fold_values(vals)
    for perm_seed in range(3):
        perm = np.random.default_rng(perm_seed).permutation(len(vals))
        assert_aggs_bitwise_equal(_fold_values(vals[perm]), whole)
    for cut in (1, 37, 200, len(vals) - 1):
        parts = _fold_values(vals[:cut]).merge(_fold_values(vals[cut:]))
        assert_aggs_bitwise_equal(parts, whole)
    assert whole.total("x") == math.fsum(vals.astype(np.float64))


# ---------------------------------------------------------------------------
# Chunked runs against the JAX package
# ---------------------------------------------------------------------------
def test_chunked_agg_bitwise_jax(runs):
    """Every column of the aggregate bitwise the JAX chunked run's; with
    a dynamic fleet the vectorized columns bitwise the reference's
    summary evaluated outside its compiled sweep instead."""
    kind, jres, tres, _, _, eager = runs
    assert jres.chunked.n_chunks == 2
    assert tres.chunked.n_chunks == -(-jres.spec.n_replicas // CHUNK[kind])
    assert tres.spec.n_replicas % CHUNK[kind]
    assert tres.metrics is None and tres.replicas is None
    ja, ta = jres.agg, tres.agg
    same = [k for k in ja.columns if eager is None or k not in VECTORIZED]
    assert_aggs_bitwise_equal(ta, ja, same)
    if eager is not None:
        assert_aggs_bitwise_equal(ta, eager, VECTORIZED)
    if kind == "tail_metrics":
        assert "resp_p99" in ta.columns and "qdepth_p50" in ta.columns
    assert ta.count() == jres.spec.n_replicas
    rows = ("completion_rate", "missed", "cancelled", "makespan")
    assert tres.by_policy(rows) == jres.by_policy(rows)


def test_telemetry_spans_follow_the_reference(runs):
    """Names, nesting and order of the span records of both chunked
    runs at two chunks; chunk 1's normalize closes before chunk 0's
    sync, and the overlap the port measured is positive."""
    _, jres, _, jrecs, trecs, _ = runs

    def shape(recs):
        names = {r["span"]: r["name"] for r in recs}
        return [(r["name"], r["depth"], names.get(r["parent"]),
                 r.get("chunk"), r.get("overlapped")) for r in recs]

    assert shape(trecs) == shape(jrecs)
    order = {(r["name"], r.get("chunk")): i for i, r in enumerate(trecs)}
    assert order[("chunk_normalize", 1)] < order[("chunk_sync", 0)]
    top = trecs[-1]
    assert top["name"] == "experiment" and top["chunked"] is True
    assert top["n_chunks"] == jres.chunked.n_chunks == 2


def test_normalize_runs_beside_the_chunk(tmp_path):
    """At a size where drawing a chunk outlasts a thread switch: chunk
    c + 1's normalize span closes before chunk c's sync span, every
    overlapped normalize parents to the ``experiment`` span, and the
    run measured normalize time that ran while a chunk was driven."""
    spec = flat_spec(TX, n=192, n_tasks=48)
    log = TTL.enable(str(tmp_path))
    try:
        res = TX.run_experiment(spec, device="cpu", chunk=64)
    finally:
        TTL.disable()
    recs = _records(TTL.read_jsonl(log.path))
    order = {(r["name"], r.get("chunk")): i for i, r in enumerate(recs)}
    top = recs[-1]
    for c in range(res.chunked.n_chunks - 1):
        assert order[("chunk_normalize", c + 1)] < order[("chunk_sync", c)]
        assert recs[order[("chunk_normalize", c + 1)]]["parent"] \
            == top["span"]
    stats = res.chunked
    assert stats.n_chunks == top["n_chunks"] == 3
    assert stats.overlap_s > 0 and top["overlap_s"] > 0
    assert 0 < stats.overlap_frac < 1
    assert stats.normalize_s >= stats.overlap_s


def test_telemetry_log_threads_stress(tmp_path):
    """More writer threads than cores, switching every microsecond: every
    record lands whole and counted, each thread's spans nest in its own
    stack, and an adopted worker's held records parent to the span that
    was open where it started."""
    import os
    import sys
    import threading
    log = TTL.TelemetryLog(str(tmp_path), "stress")
    n_threads, n_spans = 2 * (os.cpu_count() or 2) + 2, 50
    held_by = {}

    def work(i, parent):
        if parent is None:
            for j in range(n_spans):
                with log.span("outer", thread=i, j=j):
                    with log.span("inner", thread=i, j=j):
                        pass
        else:
            with log.adopted(parent) as held:
                for j in range(n_spans):
                    with log.span("worker", thread=i, j=j):
                        pass
            held_by[i] = held

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with log.span("main"):
            parent = log.open_span()
            threads = [threading.Thread(target=work, args=(
                i, parent if i % 2 else None)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        for i in sorted(held_by):
            log.write_held(held_by[i])
    finally:
        sys.setswitchinterval(switch)
        log.close()
    recs = TTL.read_jsonl(log.path)
    n_plain = (n_threads + 1) // 2
    assert len(recs) == log.n_records \
        == 1 + n_spans * (2 * n_plain + (n_threads - n_plain))
    by_id = {r["span"]: r for r in recs}
    main = next(r for r in recs if r["name"] == "main")
    for r in recs:
        if r["name"] == "inner":
            outer = by_id[r["parent"]]
            assert outer["name"] == "outer" and r["depth"] == 1
            assert (outer["thread"], outer["j"]) == (r["thread"], r["j"])
        elif r["name"] in ("outer", "main"):
            assert r["parent"] is None and r["depth"] == 0
        else:
            assert r["parent"] == main["span"] and r["depth"] == 1


def test_monolithic_telemetry_spans(tmp_path):
    """``experiment`` > ``normalize``, ``execute`` around the port's
    monolithic run, in the reference's order but for its ``compile``
    span (no executable cache yet)."""
    spec = flat_spec(TX, n=6)
    log = TTL.enable(str(tmp_path))
    try:
        res = TX.run_experiment(spec, device="cpu")
    finally:
        TTL.disable()
    recs = _records(TTL.read_jsonl(log.path))
    assert [(r["name"], r["depth"]) for r in recs] == [
        ("normalize", 1), ("execute", 1), ("experiment", 0)]
    assert recs[0]["n_replicas"] == 6 and recs[0]["reused"] is False
    assert recs[0]["parent"] == recs[1]["parent"] == recs[2]["span"]
    assert res.agg is None and res.metrics["makespan"].shape == (6,)


# ---------------------------------------------------------------------------
# Port-only invariance
# ---------------------------------------------------------------------------
def monolithic_agg(spec, **kw):
    res = TX.run_experiment(spec, device="cpu", **kw)
    return TCH.aggregate_metrics(res.metrics, res.replicas.policy_ids,
                                 spec.policy.policies), res


def test_chunk_size_invariance():
    """R = 48 through chunks of 8, 20 (a remainder) and 48: one
    aggregate, the monolithic run's fold."""
    spec = scenario_spec(TX, n=48)
    mono, _ = monolithic_agg(spec)
    for chunk in (8, 20, 48):
        res = TX.run_experiment(spec, device="cpu", chunk=chunk)
        assert_aggs_bitwise_equal(res.agg, mono)


def test_remainder_chunk_and_keep_replicas():
    """96 = 7 x 13 + 5: the short tail chunk folds identically, and
    ``keep_replicas`` gives back the monolithic columns bitwise."""
    spec = flat_spec(TX)
    mono, res = monolithic_agg(spec)
    ch = TX.run_experiment(spec, device="cpu", chunk=13, keep_replicas=True)
    assert ch.chunked.n_chunks == 8
    assert_aggs_bitwise_equal(ch.agg, mono)
    assert list(ch.metrics) == list(res.metrics)
    for k in res.metrics:
        assert torch.equal(ch.metrics[k], res.metrics[k]), k


def test_permuted_replicas_fold_identically():
    """The replicas in another order (through ``replicas=``) give the
    same aggregate."""
    spec = workflow_spec(TX)
    reps = TX.normalize(spec, device="cpu")
    perm = torch.from_numpy(np.random.default_rng(1).permutation(36))
    shuffled = dataclasses.replace(
        reps, tasks=reps.tasks.take(perm), mtype=reps.mtype[perm],
        tables=reps.tables.take(perm), policy_ids=reps.policy_ids[perm],
        dynamics=reps.dynamics.take(perm), parents=reps.parents[perm])
    a = TX.run_experiment(spec, device="cpu", chunk=10).agg
    b = TX.run_experiment(spec, device="cpu", chunk=7, replicas=shuffled).agg
    assert_aggs_bitwise_equal(a, b)


@pytest.mark.parametrize("policy", PORTED)
def test_chunked_matches_monolithic_every_policy(policy):
    spec = TX.ExperimentSpec(12, TX.FleetAxis(4, 2), TX.WorkloadAxis(12, 3),
                             policy=TX.PolicyAxis((policy,)), seed=2)
    mono, _ = monolithic_agg(spec)
    ch = TX.run_experiment(spec, device="cpu", chunk=5)
    assert_aggs_bitwise_equal(ch.agg, mono)


def test_by_policy_off_the_aggregate():
    """``by_policy`` of a chunked result: exact (correctly rounded fsum)
    per-policy means of the monolithic columns."""
    spec = flat_spec(TX)
    _, res = monolithic_agg(spec)
    ch = TX.run_experiment(spec, device="cpu", chunk=16)
    pids = res.replicas.policy_ids.numpy()
    for row, mono in zip(ch.by_policy(), res.by_policy()):
        assert row["replicas"] == mono["replicas"]
        sel = pids == TP.POLICY_IDS[row["policy"]]
        for k in ("completion_rate", "missed", "energy", "makespan"):
            vals = res.metrics[k].numpy().astype(np.float64)[sel]
            assert row[k] == math.fsum(vals) / sel.sum(), (row, k)
            np.testing.assert_allclose(row[k], mono[k], rtol=1e-5)
    s = ch.agg.summary()["makespan"]
    vals = res.metrics["makespan"].numpy().astype(np.float64)
    assert s["count"] == 96 and s["min"] == vals.min() \
        and s["max"] == vals.max()


# ---------------------------------------------------------------------------
# Validation and memory
# ---------------------------------------------------------------------------
def test_chunked_validation_errors():
    """The reference's errors, message for message."""
    jspec, tspec = flat_spec(X, n=8), flat_spec(TX, n=8)
    cases = [
        (dict(chunk=0), "chunk must be >= 1"),
        (dict(chunk=TCH.MAX_CHUNK + 1), "exact-sum"),
        (dict(chunk=4, trace=True), "trace"),
        (dict(keep_replicas=True), "only apply with chunk"),
    ]
    assert TCH.MAX_CHUNK == JCH.MAX_CHUNK
    assert tuple(TCH.SWEEP_SPEC) == tuple(JCH.SWEEP_SPEC)
    for kw, match in cases:
        trace = kw.pop("trace", False)
        with pytest.raises(ValueError, match=match) as want:
            X.run_experiment(jspec.with_(trace=trace), **kw)
        with pytest.raises(ValueError, match=match) as got:
            TX.run_experiment(tspec.with_(trace=trace), device="cpu", **kw)
        assert str(got.value) == str(want.value)
    ids = np.full(2, TP.POLICY_IDS["rr"], np.int32)
    with pytest.raises(ValueError, match="outside the spec") as want:
        JCH.aggregate_metrics({"x": jnp.zeros(2)}, ids, ("mct",))
    with pytest.raises(ValueError, match="outside the spec") as got:
        TCH.aggregate_metrics({"x": torch.zeros(2)}, ids, ("mct",))
    assert str(got.value) == str(want.value)
    reps = TX.normalize(flat_spec(TX, n=4), device="cpu")
    with pytest.raises(ValueError, match="replicas carry 4 rows"):
        TX.run_experiment(tspec, device="cpu", chunk=2, replicas=reps)


def test_host_memory_stays_o_chunk():
    """tracemalloc bound on a chunked run: host staging tracks the chunk,
    not the grid (normalize of the whole grid allocates several times
    more)."""
    spec = flat_spec(TX, n=256, n_tasks=24)
    TX.run_experiment(spec.with_(n_replicas=8), device="cpu", chunk=4)
    tracemalloc.start()
    TX.normalize(spec, device="cpu")
    _, mono_peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    tracemalloc.start()
    TX.run_experiment(spec, device="cpu", chunk=32)
    _, chunk_peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert chunk_peak < mono_peak / 3, (chunk_peak, mono_peak)


def test_entry_points_default_to_the_card():
    """No silent CPU fallback: without a GPU the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device runs")
    spec = flat_spec(TX, n=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TX.run_experiment(spec, chunk=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TX.normalize_chunk(spec, 0, 2)
