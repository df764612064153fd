"""Learned-scheduling harness: train on one scenario grid, evaluate on a
held-out grid, report learned-against-heuristic scoreboards.

The counterpart of ``repro.launch.learn``:

  1. ``grid_spec`` declares a (failure rate x DVFS x arrival pattern)
     scenario grid as an ``ExperimentSpec``; ``normalize`` of it is the
     input of training and of the scoreboard (``make_grid`` is the
     deprecated tuple-returning shim).
  2. ``core.train_policy.train`` runs antithetic ES on the training grid,
     one ``run_sweep`` of (2 pop + 1) x S replicas a generation.
  3. ``scoreboard`` evaluates every heuristic and the trained policies
     on the held-out grid (other seeds and another arrival mixture) as
     one ``run_sweep`` over policy x scenario replicas, each replica with
     its policy id and the learned ones with their trained weights: the
     rows of one sweep per policy, which the reference runs.
  4. ``viz.policy_scoreboard`` draws the rows; ``main`` writes
     ``scoreboard.json`` and ``scoreboard.svg``.

Run it:  PYTHONPATH=src python -m repro_torch.launch.learn --smoke
         [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine as E
from repro_torch.core import neural as NN
from repro_torch.core import schedulers as P
from repro_torch.core import train_policy as TP
from repro_torch.core import viz
from repro_torch.launch.experiment import (ExperimentSpec, FleetAxis,
                                           PolicyAxis, ScenarioAxis,
                                           WorkloadAxis, normalize,
                                           summarize_replica)

BASELINES = ["fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
             "maxmin", "edf_mct"]


def grid_spec(n_replicas: int, n_tasks: int, n_machines: int, *,
              n_task_types: int = 4, n_machine_types: int = 3,
              fail_rates=(0.0, 0.1), dvfs_states=("nominal", "powersave"),
              arrivals=("poisson", "bursty"), rate: float = 4.0,
              spot_frac: float = 0.5, mttr: float = 4.0,
              n_intervals: int = 4, seed: int = 0) -> ExperimentSpec:
    """(failure rate x DVFS x arrival pattern) evaluation grid as a spec.
    The policy axis is a single placeholder (``mct``): the scoreboard
    runs every policy on the same normalized grid, which pairs the
    comparison."""
    return ExperimentSpec(
        n_replicas, FleetAxis(n_machines, n_machine_types),
        WorkloadAxis(n_tasks, n_task_types, rate, arrivals=tuple(arrivals)),
        scenario=ScenarioAxis(tuple(fail_rates), tuple(dvfs_states),
                              spot_frac, mttr, n_intervals),
        policy=PolicyAxis(("mct",)), seed=seed)


def make_grid(n_replicas: int, n_tasks: int, n_machines: int, *,
              device="cuda", **kw) -> tuple:
    """DEPRECATED shim -> ``normalize(grid_spec(...)).legacy()``."""
    from repro_torch.launch.sim import _deprecated
    _deprecated("make_grid", "normalize(learn.grid_spec(...))")
    return normalize(grid_spec(n_replicas, n_tasks, n_machines, **kw),
                     device).legacy()


def _shared_weights(policies, trained: dict, device) -> NN.PolicyParams:
    """One shared ``PolicyParams`` for a sweep of ``policies``: each
    learned family from its trained weights, else zeros (each learned
    policy reads only its own family)."""
    out = NN.default_params(device)
    for name in NN.LEARNED_POLICIES:
        if name in policies and name in trained:
            out = out._replace(**{name: getattr(trained[name].to(device),
                                                name)})
    return out


def scoreboard(inputs, policies: list[str],
               trained: dict[str, NN.PolicyParams] | None = None,
               sim_params: E.SimParams = E.SimParams(),
               energy_weight: float = 0.2,
               e_scale: float | None = None) -> tuple[list[dict], float]:
    """-> (rows, e_scale): one row per policy, best first, with the mean
    score and metrics on a paired grid (``inputs``: ``Replicas`` or the
    legacy tuple, on the device to run on).  ``trained`` maps learned
    policy names to their weights; ``e_scale`` defaults to MCT's
    grid-mean energy (as in training), from this sweep."""
    tt, mt, tb, dyn = TP.grid_inputs(inputs)
    dev = mt.device
    n_scen, n_pol = mt.shape[0], len(policies)
    trained = trained or {}
    idx = torch.arange(n_pol * n_scen, device=dev) % n_scen
    pids = torch.tensor([P.POLICY_IDS[p] for p in policies],
                        dtype=torch.int32).repeat_interleave(n_scen).to(dev)
    tables, dynamics = TP.tile(tb, idx), TP.tile(dyn, idx)
    st = E.run_sweep(TP.tile(tt, idx), mt[idx], tables, pids, sim_params,
                     dynamics=dynamics,
                     policy_params=_shared_weights(policies, trained, dev))
    cols = summarize_replica(st, tables, dynamics)
    metrics = {pol: {k: v[i * n_scen:(i + 1) * n_scen]
                     for k, v in cols.items()}
               for i, pol in enumerate(policies)}
    if e_scale is None:
        ref = metrics.get("mct") or next(iter(metrics.values()))
        e_scale = float(np.mean(ref["energy"].cpu().numpy()))
    rows = []
    for pol, m in metrics.items():
        score = TP.miss_energy_score(m, e_scale, energy_weight)
        m = {k: v.cpu().numpy() for k, v in m.items()}
        rows.append({
            "policy": pol + ("*" if pol in trained else ""),
            "score": round(float(score.cpu().numpy().mean()), 4),
            "completion_rate": round(float(np.mean(m["completion_rate"])),
                                     4),
            "missed": round(float(np.mean(m["missed"] + m["cancelled"]
                                          + m["preempted"])), 2),
            "energy": round(float(np.mean(m["energy"])), 1),
            "makespan": round(float(np.mean(m["makespan"])), 2),
        })
    return sorted(rows, key=lambda r: r["score"]), e_scale


def train_and_evaluate(*, n_train: int = 16, n_test: int = 16,
                       n_tasks: int = 48, n_machines: int = 6,
                       cfg: TP.ESConfig = TP.ESConfig(),
                       policies: list[str] = ("mlp",),
                       baselines: list[str] = BASELINES,
                       sim_params: E.SimParams = E.SimParams(),
                       seed: int = 0, out_dir: str | None = None,
                       device="cuda") -> dict:
    """Train on one grid, scoreboard on a held-out grid (other seeds and
    ``diurnal``/``onoff`` arrivals that training never saw), on
    ``device``."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    train_grid = normalize(grid_spec(
        n_train, n_tasks, n_machines, arrivals=("poisson", "bursty"),
        seed=seed), dev)
    test_grid = normalize(grid_spec(
        n_test, n_tasks, n_machines,
        arrivals=("poisson", "diurnal", "onoff"), seed=seed + 10_000), dev)
    trained, train_hist = {}, {}
    for pol in policies:
        res = TP.train(train_grid, policy=pol, sim_params=sim_params,
                       cfg=cfg)
        trained[pol] = res.params
        train_hist[pol] = res.history
    rows, e_scale = scoreboard(test_grid, list(baselines) + list(policies),
                               trained, sim_params, cfg.energy_weight)
    payload = {
        "rows": rows, "e_scale": e_scale, "history": train_hist,
        "config": {"pop": cfg.pop, "sigma": cfg.sigma, "lr": cfg.lr,
                   "generations": cfg.generations,
                   "energy_weight": cfg.energy_weight,
                   "n_train": n_train, "n_test": n_test,
                   "n_tasks": n_tasks, "n_machines": n_machines,
                   "seed": seed, "device": str(dev)},
        "seconds": round(time.perf_counter() - t0, 2),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "scoreboard.json"), "w") as f:
            json.dump(payload, f, indent=1)
        viz.save(os.path.join(out_dir, "scoreboard.svg"),
                 viz.policy_scoreboard(rows))
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny budget: few generations, small fleet")
    ap.add_argument("--generations", type=int, default=None)
    ap.add_argument("--pop", type=int, default=None)
    ap.add_argument("--out", default="results/learned")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        kw = dict(n_train=6, n_test=6, n_tasks=24, n_machines=4)
    else:
        kw = dict(n_train=24, n_test=24, n_tasks=64, n_machines=8)
    pop = args.pop if args.pop is not None else (4 if args.smoke else 12)
    gens = args.generations if args.generations is not None \
        else (3 if args.smoke else 30)
    cfg = TP.ESConfig(pop=pop, generations=gens, seed=args.seed)
    payload = train_and_evaluate(cfg=cfg, out_dir=args.out, seed=args.seed,
                                 device=args.device, **kw)
    print(f"# learned-vs-heuristic scoreboard (held-out grid, "
          f"{payload['seconds']}s)")
    cols = ["policy", "score", "completion_rate", "missed", "energy",
            "makespan"]
    print(" | ".join(cols))
    for r in payload["rows"]:
        print(" | ".join(str(r[c]) for c in cols))
    print(f"\nwrote {args.out}/scoreboard.json (+ .svg)")


if __name__ == "__main__":
    main()
