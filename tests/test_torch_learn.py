"""The port's learned-scheduling harness (``launch/learn.py``) and the
learned policies through the streaming and chunked experiment paths,
against the JAX package.

Tolerance 0 throughout: ``grid_spec`` draws bit-equal replicas; the
scoreboard rows (the reference runs one sweep per policy, the port one
sweep over policy x scenario replicas) are equal with the weights of a
JAX ``train`` carried across; streaming summary columns and the chunked
``SweepAgg`` of learned specs are bitwise the reference's on
exact-product replicas (unit noise, powers-of-two power tables and DVFS
multipliers: ``tests/test_torch_chunked.py`` explains why).
"""
from __future__ import annotations

import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch
from test_torch_chunked import (_exact, _fields, _port_reps, _same_fields,
                                assert_aggs_bitwise_equal)

from repro.core import neural as JN
from repro.core import train_policy as JTP
from repro.launch import experiment as X
from repro.launch import learn as JL
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.launch import experiment as TX
from repro_torch.launch import learn as TL
from repro_torch.launch import sim as TS

pytestmark = pytest.mark.torch


def port_params(pp):
    return interop.policy_params_from_numpy(JN.params_to_numpy(pp), "cpu")


@pytest.mark.parametrize("kw", [dict(), dict(arrivals=("poisson", "diurnal",
                                                       "onoff"), seed=3)])
def test_grid_spec_normalize_bit_equal(kw):
    want = X.normalize(JL.grid_spec(12, 16, 3, **kw))
    got = TX.normalize(TL.grid_spec(12, 16, 3, **kw), device="cpu")
    _same_fields(_fields(got), _fields(want), "grid_spec")


def test_make_grid_shim():
    TS._WARNED.discard("make_grid")
    with pytest.warns(DeprecationWarning, match="make_grid"):
        legacy = TL.make_grid(6, 12, 3, device="cpu", seed=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TL.make_grid(6, 12, 3, device="cpu", seed=2)
    want = TX.normalize(TL.grid_spec(6, 12, 3, seed=2), "cpu").legacy()
    assert len(legacy) == 5
    for a, b in zip(_fields(TX.Replicas(*legacy)).values(),
                    _fields(TX.Replicas(*want)).values()):
        assert a is b is None or np.array_equal(a, b)


@pytest.fixture(scope="module")
def scoreboards():
    """Weights from a JAX ``train`` (two generations), then the two
    packages' scoreboards on a held-out exact-product grid."""
    train = X.normalize(JL.grid_spec(4, 16, 3, seed=0)).legacy()
    res = JTP.train(train, "mlp", cfg=JTP.ESConfig(pop=2, generations=2,
                                                    sigma=0.3, seed=1))
    test = _exact(X.normalize(JL.grid_spec(
        6, 16, 3, arrivals=("poisson", "diurnal", "onoff"), seed=10_000)))
    policies = JL.BASELINES + ["mlp", "linear"]
    want = JL.scoreboard(test.legacy(), policies, {"mlp": res.params})
    treps = _port_reps(test)
    trained = {"mlp": port_params(res.params)}
    got = TL.scoreboard(treps, policies, trained)
    return treps, policies, trained, want, got


def test_scoreboard_rows_equal_jax(scoreboards):
    _, policies, _, want, got = scoreboards
    assert got[1] == want[1]                      # e_scale
    assert got[0] == want[0]
    assert [r["policy"] for r in got[0]].count("mlp*") == 1
    assert len(got[0]) == len(policies)


def test_scoreboard_is_one_sweep_of_per_policy_rows(scoreboards,
                                                    monkeypatch):
    """The one sweep over policy x scenario replicas gives the rows of
    one sweep per policy."""
    treps, policies, trained, _, (rows, e_scale) = scoreboards
    calls = []
    real = TE.run_sweep
    monkeypatch.setattr(TE, "run_sweep", lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])
    again, _ = TL.scoreboard(treps, policies, trained, e_scale=e_scale)
    assert calls == [1] and again == rows
    by = {r["policy"]: r for r in rows}
    for pol in ("mct", "mlp", "linear", "maxmin"):
        (one,), _ = TL.scoreboard(treps, [pol], trained, e_scale=e_scale)
        assert one == by[one["policy"]], pol


def test_streaming_learned_spec_bitwise():
    pp = JN.init_params(6)
    specs = [lib.ExperimentSpec(
        12, lib.FleetAxis(4), lib.WorkloadAxis(24, streaming=8,
                                               stream_chunk=5),
        policy=lib.PolicyAxis(("mlp", "linear", "mct")), learned=True,
        seed=8) for lib in (X, TX)]
    reps = _exact(X.normalize(specs[0]))
    want = X.run_experiment(specs[0], replicas=reps, policy_params=pp)
    got = TX.run_experiment(specs[1], device="cpu", replicas=_port_reps(reps),
                            policy_params=port_params(pp))
    assert set(got.metrics) == set(want.metrics)
    for k, col in want.metrics.items():
        a, b = np.asarray(col), got.metrics[k].numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert got.window is not None


def test_chunked_learned_spec_bitwise():
    pp = JN.init_params(9)
    specs = [lib.ExperimentSpec(
        30, lib.FleetAxis(4, 2), lib.WorkloadAxis(16, 3),
        policy=lib.PolicyAxis(("mlp", "ee_mct", "linear")), learned=True,
        seed=2) for lib in (X, TX)]
    reps = _exact(X.normalize(specs[0]))
    want = X.run_experiment(specs[0], chunk=15, replicas=reps,
                            policy_params=pp).agg
    got = TX.run_experiment(specs[1], chunk=8, replicas=_port_reps(reps),
                            device="cpu", policy_params=port_params(pp)).agg
    assert_aggs_bitwise_equal(got, want)


def test_main_smoke_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "learned")
    TL.main(["--smoke", "--device", "cpu", "--generations", "1", "--pop",
             "2", "--out", out])
    payload = json.load(open(os.path.join(out, "scoreboard.json")))
    assert [r["policy"] for r in payload["rows"]].count("mlp*") == 1
    assert len(payload["rows"]) == len(TL.BASELINES) + 1
    assert payload["config"]["device"] == "cpu"
    assert open(os.path.join(out, "scoreboard.svg")).read().startswith(
        "<svg")
    assert "learned-vs-heuristic scoreboard" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TL.train_and_evaluate(n_train=2, n_test=2, n_tasks=4,
                                  n_machines=2)
    assert jax.devices()[0].platform == "cpu"
