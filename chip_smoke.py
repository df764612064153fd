"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full check, one card

    python3 chip_smoke.py --paths serve --serve-tiny   # short first call
    python3 chip_smoke.py --replicas 512 --flat-replicas 512   # short

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device: the card's name and power limit;
  2. build: nvcc builds the three CUDA libraries from
     ``src/repro_torch/kernels/csrc``, one nvcc each, all at once;
  3. kernels: each kernel against its plain PyTorch version on the card:
     the five scheduling kernels bitwise, on random and edge-case inputs;
     flash attention at atol = rtol = 2e-5 (f32) / 2e-2 (bf16) and the
     grouped matmul at atol = 2e-5 D, rtol = 2e-5 (f32) / 2e-2 D, 2e-2
     (bf16) with its padding rows exactly 0 (the tolerances of
     ``tests/test_kernels.py``);
  4. main paths, each driven through its entry point with the launch
     counts set to 0 just before it and read just after, every kernel of
     the path launched, and kernel inputs captured from the run
     re-checked against the plain versions:
       flat      ``run_experiment``, 4096 replicas x 1024 tasks x 32
                 machines, ten policies;
       scenario  the same width with a ``ScenarioAxis`` (fail rates 0,
                 0.05, 0.1 x DVFS nominal, powersave, turbo, half the
                 replicas on spot machines), ten policies;
       serve     ``ServingEngine(run_mode="real")``, ee_mct over 4
                 machines of 2 types, 8 Poisson requests of two apps:
                 qwen2-1.5b as published (28 layers) and deepseek-moe-16b
                 at its published widths cut to 8 layers (1 dense + 7
                 MoE), random f32 weights from a seeded generator,
                 prompt 1024 and 32 generated tokens; every request
                 completes and each model kernel launches exactly as
                 often as the shapes imply;
  5. card vs CPU: a 64 x 128 x 8 flat sweep and scenario sweep on the
     card and on the CPU must give bitwise-equal final states and
     summaries; the tiny configurations of both apps through the same
     ``ServingEngine`` on both, the card teacher-forced with the CPU's
     tokens, must agree on every logit to atol = rtol = 1e-4 and on the
     greedy token wherever the CPU's top-2 margin exceeds 1e-3;
  6. timings: each kernel, its plain version and, where one PyTorch call
     computes the same function, that call, on the inputs of the
     captured main-path call with the most work, rotated over copies
     larger than the L2 cache: device time (profiler) and stream time
     (CUDA events), beside the least time the card could take for that
     call's data (see ``bound`` and ``model_bound``).
After 4 a profiled window of each path (the sweeps' first 32 event
steps; one request of each app) gives the device's busy and idle share.
The last two lines are the kernels JSON line and the result line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")
SCENARIO = dict(fail_rates=(0.0, 0.05, 0.1),
                dvfs_states=("nominal", "powersave", "turbo"),
                spot_frac=0.5)
PATHS = ("flat", "scenario")          # the sweep paths
ALL_PATHS = PATHS + ("serve",)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SECTOR = 32                   # bytes the memory system moves at least
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/sched_argmin.cu"
MODEL_KERNELS = ("flash_attention", "grouped_matmul")
MODEL_SOURCE = "src/repro_torch/kernels/csrc/{}.cu"
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:92",
    "grouped_matmul": "src/repro/kernels/grouped_matmul.py:50",
    "masked_argmin": "src/repro/kernels/sched_argmin.py:89",
    "fused_minmin": "src/repro/kernels/sched_argmin.py:227",
    "fused_maxmin": "src/repro/kernels/sched_argmin.py:427",
    "fused_start_pick": "src/repro/kernels/sched_argmin.py:315",
    "fused_event_bounds": "src/repro/kernels/sched_argmin.py:388",
}
CAPTURE_AT = (1, 40, 400, 4000)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------------
def bits(x: torch.Tensor) -> torch.Tensor:
    """Bit pattern of a tensor, so that -0.0 and +0.0 compare unequal."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x.to(torch.int32)


def compare(name: str, got: tuple, want: tuple) -> float:
    """Raise unless every output is bitwise equal; returns the largest
    absolute difference of the float outputs (0.0 when equal)."""
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(bits(g), bits(w)):
            bad = (bits(g) != bits(w)).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: kernel != plain at {bad}")
        if g.is_floating_point():
            d = (g - w).abs()
            d = d[torch.isfinite(d)]
            err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def kernel_cases(dev):
    """(name, label, args, kwargs) cases: random shapes incl. ragged and
    single-element ones, plus the contract's edge cases."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape):
        return torch.rand(shape, generator=g).to(dev)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int32).to(dev)

    cases = []
    # masked_argmin: (R, N, M) values + mask
    for r, n, m in ((4096, 1, 32), (64, 1024, 32), (7, 33, 5), (3, 1, 1)):
        v = (rnd(r, n, m) * 8).floor() * 0.5      # many duplicate minima
        cases.append(("masked_argmin", f"random {r}x{n}x{m}",
                      (v, rnd(r, n, m) < 0.6), {}))
    v = rnd(5, 9, 4)
    cases.append(("masked_argmin", "empty mask",
                  (v, torch.zeros_like(v, dtype=torch.bool)), {}))
    v = torch.full((5, 9, 4), float("inf"), device=dev)
    mk = torch.ones_like(v, dtype=torch.bool)
    mk[:, 3, 2] = False
    cases.append(("masked_argmin", "+inf valid loses to masked BIG",
                  (v, mk), {}))
    cases.append(("masked_argmin", "valid cells >= BIG",
                  (torch.full((5, 9, 4), 2e30, device=dev), mk), {}))
    z = torch.zeros((6, 11, 3), device=dev)
    z[:, ::2] = -0.0
    cases.append(("masked_argmin", "-0.0/+0.0 ties",
                  (z, torch.ones_like(z, dtype=torch.bool)), {}))
    # fused_minmin
    for r, n, m, t in ((455, 1024, 32, 4), (5, 1000, 7, 3), (3, 1, 1, 1)):
        cases.append(("fused_minmin", f"random {r}x{n}x{m}",
                      ((rnd(r, m) * 20).floor(), rnd(r, n) < 0.5,
                       rnd(r, m) < 0.7, randint(0, t, r, n),
                       (rnd(r, t, m) * 9).floor() + 0.5), {}))
    r, n, m, t = 4, 40, 6, 3
    base = (rnd(r, m), rnd(r, n) < 0.5, rnd(r, m) < 0.7,
            randint(0, t, r, n), rnd(r, t, m))
    cases.append(("fused_minmin", "empty batch",
                  (base[0], torch.zeros_like(base[1]), *base[2:]), {}))
    cases.append(("fused_minmin", "no room",
                  (base[0], base[1], torch.zeros_like(base[2]), *base[3:]),
                  {}))
    cases.append(("fused_minmin", "all ties",
                  (torch.zeros(r, m, device=dev), torch.ones_like(base[1]),
                   torch.ones_like(base[2]), base[3],
                   torch.ones(r, t, m, device=dev)), {}))
    big = base[4].clone()
    big[:, 0, :] = 2e30
    big[:, 1, :] = float("inf")
    cases.append(("fused_minmin", "completions >= BIG and +inf",
                  (base[0], base[1], base[2], base[3], big), {}))
    cases.append(("fused_minmin", "-0.0/+0.0",
                  (torch.full((r, m), -0.0, device=dev), base[1], base[2],
                   base[3], torch.zeros(r, t, m, device=dev)), {}))
    # fused_maxmin: the Min-Min cases, and those only its two-level
    # reduction reaches
    for name, label, args, kw in [c for c in cases
                                  if c[0] == "fused_minmin"]:
        cases.append(("fused_maxmin", label, args, kw))
    signed = torch.zeros(r, t, m, device=dev)
    signed[..., ::2] = -0.0
    cases.append(("fused_maxmin", "-0.0 row minima",
                  (torch.full((r, m), -0.0, device=dev), base[1],
                   torch.ones_like(base[2]), base[3], signed), {}))
    one_b, one_r = torch.zeros_like(base[1]), torch.zeros_like(base[2])
    one_b[:, 5], one_r[:, 2] = True, True
    cases.append(("fused_maxmin", "one valid pair",
                  (base[0], one_b, one_r, base[3], base[4]), {}))
    mixed_b, mixed_r = base[1].clone(), base[2].clone()
    mixed_b[0], mixed_r[1], mixed_r[2] = False, False, True
    cases.append(("fused_maxmin", "mixed empty and full replicas",
                  (base[0], mixed_b, mixed_r, base[3], base[4]), {}))
    cases.append(("fused_maxmin", "scores below -BIG",
                  (torch.full((r, m), float("-inf"), device=dev), base[1],
                   base[2], base[3], base[4]), {}))
    # fused_start_pick
    for r, n, m in ((4096, 1024, 32), (5, 1000, 7), (3, 1, 1)):
        cases.append(("fused_start_pick", f"random {r}x{n}x{m}",
                      (randint(0, 8, r, n), randint(-1, m + 1, r, n),
                       randint(0, 1 << 20, r, n), m), {"in_mq": 2}))
    r, n, m = 4, 64, 5
    st = torch.full((r, n), 2, dtype=torch.int32, device=dev)
    cases.append(("fused_start_pick", "equal seqs (lowest id wins)",
                  (st, randint(0, m, r, n),
                   torch.full((r, n), 7, dtype=torch.int32, device=dev), m),
                  {"in_mq": 2}))
    seq = randint(0, 1 << 20, r, n)
    seq[:, 5:] = 2**31 - 1
    cases.append(("fused_start_pick", "INT_MAX seqs",
                  (randint(1, 4, r, n), randint(0, m, r, n), seq, m),
                  {"in_mq": 2}))
    cases.append(("fused_start_pick", "negative seqs",
                  (st, randint(0, m, r, n), randint(-1000, 1000, r, n), m),
                  {"in_mq": 2}))
    # fused_event_bounds
    kw = {"not_arrived": 0, "live_lo": 1, "live_hi": 3}
    for r, n in ((4096, 1024), (5, 1000), (3, 1)):
        cases.append(("fused_event_bounds", f"random {r}x{n}",
                      (randint(0, 8, r, n), rnd(r, n) * 100,
                       rnd(r, n) * 200), kw))
    r, n = 4, 50
    cases.append(("fused_event_bounds", "empty sets (+inf)",
                  (torch.full((r, n), 7, dtype=torch.int32, device=dev),
                   rnd(r, n), rnd(r, n)), kw))
    zs = torch.zeros((r, n), device=dev)
    zs[:, 1::3] = -0.0
    cases.append(("fused_event_bounds", "-0.0/+0.0 and +inf",
                  (randint(0, 4, r, n), zs,
                   torch.full((r, n), float("inf"), device=dev)), kw))
    return cases


def check_kernels(K, KREF, dev) -> dict:
    errs = {name: 0.0 for name in K.NAMES}
    for name, label, args, kw in kernel_cases(dev):
        got = getattr(K, name)(*args, **kw)
        torch.cuda.synchronize()
        want = getattr(KREF, name + "_ref")(*args, **kw)
        errs[name] = max(errs[name], compare(f"{name} {label}", got, want))
        log("3 kernels", f"{name} {label}: bitwise equal")
    return errs


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------
def fields(st):
    t, m = st.tasks, st.machines
    return {"time": st.time, "n_events": st.n_events, "status": t.status,
            "machine": t.machine, "seq": t.seq, "t_start": t.t_start,
            "t_end": t.t_end, "busy_until": m.busy_until,
            "active_time": m.active_time, "energy": m.energy,
            "mq_count": st.mq_count, "n_live": st.n_live,
            "n_preempts": st.n_preempts, "n_batch": st.n_batch}


@contextlib.contextmanager
def capturing(K, at):
    """Within the block, each kernel wrapper of ``K`` clones its inputs
    at the calls numbered in ``at`` (1-based, per wrapper) into the
    yielded ``{name: [(call, args, kwargs), ...]}``."""
    captured = {name: [] for name in K.NAMES}
    originals = {name: getattr(K, name) for name in K.NAMES}

    def wrap(name, fn):
        count = [0]

        def wrapped(*args, **kw):
            count[0] += 1
            if count[0] in at:
                captured[name].append((count[0], tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args), dict(kw)))
            return fn(*args, **kw)
        return wrapped

    for name, fn in originals.items():
        setattr(K, name, wrap(name, fn))
    try:
        yield captured
    finally:
        for name, fn in originals.items():
            setattr(K, name, fn)


def make_spec(X, E, path, n_rep, n_tasks, n_mach, seed=0, max_events=None):
    """The spec of a main path: ``flat`` or ``scenario``."""
    scenario = X.ScenarioAxis(**SCENARIO) if path == "scenario" else None
    return X.ExperimentSpec(n_rep, X.FleetAxis(n_mach),
                            X.WorkloadAxis(n_tasks), scenario=scenario,
                            policy=X.PolicyAxis(POLICIES),
                            sim=E.SimParams(max_events=max_events),
                            seed=seed)


def run_main(X, E, K, S, dev, path, n_rep, n_tasks, n_mach):
    """Drive one main path through ``run_experiment``, the launch counts
    set to 0 just before and read just after; returns the result, the
    launches and the inputs captured from the run."""
    phase = f"4 {path}"
    spec = make_spec(X, E, path, n_rep, n_tasks, n_mach)
    t0 = time.perf_counter()
    reps = X.normalize(spec, device=dev)
    torch.cuda.synchronize()
    log(phase, f"normalize {n_rep} replicas x {n_tasks} tasks x "
        f"{n_mach} machines on the host: {time.perf_counter() - t0:.2f} s")
    stats = E.RunStats()
    torch.cuda.reset_peak_memory_stats()
    with capturing(K, CAPTURE_AT) as captured:
        K.reset_launches()
        t0 = time.perf_counter()
        res = X.run_experiment(spec, device=dev, replicas=reps, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.launches)
    for row in res.by_policy(("completion_rate", "missed", "cancelled",
                              "preempted", "requeues", "availability",
                              "energy", "makespan", "mean_response")):
        log(phase, json.dumps(row))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(phase, f"execute {wall:.3f} s (synchronised); event steps "
        f"{stats.events}, drain trips {stats.drain_trips}, host reads "
        f"{stats.host_reads}; peak device memory {peak:.2f} GiB; "
        f"{gpu_line()}")
    if path == "scenario":
        log(phase, f"preempted {int(res.metrics['preempted'].sum())} tasks,"
            f" requeued {int(res.metrics['requeues'].sum())} evictions; "
            f"mean availability "
            f"{float(res.metrics['availability'].mean()):.4f}")
    log(phase, f"kernel launches {json.dumps(launches)}")
    for name in K.NAMES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the {path} path")
    st = res.state
    status = st.tasks.status
    if not bool((status >= S.COMPLETED).all()):
        raise AssertionError(f"live tasks left at the end of the {path} "
                             "path")
    for key, col in res.metrics.items():
        if col.shape != (n_rep,) or not bool(torch.isfinite(
                col.float()).all()):
            raise AssertionError(f"summary column {key} is not finite "
                                 f"(R,): {tuple(col.shape)}")
    for key in ("completion_rate", "availability"):
        col = res.metrics[key]
        if not bool(((col >= 0) & (col <= 1)).all()):
            raise AssertionError(f"{key} outside [0, 1]")
    if path == "scenario" and not int(st.n_preempts.sum()):
        raise AssertionError("the scenario path evicted no task")
    log(phase, f"all {n_rep * n_tasks} tasks terminal; summaries finite")
    return res, launches, captured


def recheck_captured(K, KREF, captured, path) -> None:
    for name in K.NAMES:
        for call, args, kw in captured[name]:
            got = getattr(K, name)(*args, **kw)
            want = getattr(KREF, name + "_ref")(*args, **kw)
            compare(f"{name} {path} call {call}", got, want)
            log("3 kernels", f"{name} captured at {path}-path call {call}: "
                "bitwise equal")


def card_vs_cpu(X, E, dev, path) -> None:
    spec = make_spec(X, E, path, 64, 128, 8, seed=1)
    on_card = X.run_experiment(spec, device=dev)
    on_cpu = X.run_experiment(spec, device="cpu")
    got, want = fields(on_card.state), fields(on_cpu.state)
    for key in want:
        if not torch.equal(bits(got[key].cpu()), bits(want[key])):
            raise AssertionError(f"{path}: card != CPU in {key}")
    for key in on_cpu.metrics:
        if not torch.equal(bits(on_card.metrics[key].cpu()),
                           bits(on_cpu.metrics[key])):
            raise AssertionError(f"{path}: card != CPU in summary {key}")
    log("5 card=cpu", f"64x128x8 {path} sweep: every state field and "
        "summary column bitwise equal to the CPU run")


# ---------------------------------------------------------------------------
# timings
# ---------------------------------------------------------------------------
COLD_BYTES = 128 << 20     # > 2x the H100's 50 MB L2


def cold_sets(args) -> list:
    """Copies of a call's inputs, together larger than the L2 cache, so
    that calls rotating over them read their inputs from HBM."""
    size = nbytes(*[a for a in args if isinstance(a, torch.Tensor)])
    copies = max(2, min(1024, -(-COLD_BYTES // size)))
    return [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args) for _ in range(copies)]


def calls(fn, sets, kw):
    reps = max(50, len(sets))
    return reps, (lambda: [fn(*sets[i % len(sets)], **kw)
                           for i in range(reps)])


def time_ms(fn, sets, kw) -> float:
    """Stream time per call: CUDA events around back-to-back calls that
    rotate over ``sets`` (includes the host's launch cost when it exceeds
    the kernel's)."""
    reps, run = calls(fn, sets, kw)
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_activity(prof) -> list:
    """(name, start_us, end_us) of every device activity a profile saw."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def device_ms(fn, sets, kw) -> float:
    """Device time per call: the summed durations of every kernel the
    calls ran, from the profiler (0.0 if it saw no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    reps, run = calls(fn, sets, kw)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(end - start for _, start, end in device_activity(prof)) \
        / reps / 1e3


def busy_us(spans) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def sector_bytes(x: torch.Tensor, sel: torch.Tensor) -> int:
    """Bytes of the 32-byte sectors of contiguous ``x`` that hold an
    element selected by ``sel`` (broadcast to ``x``'s shape)."""
    flat = torch.nonzero(sel.expand(x.shape).reshape(-1))[:, 0]
    return int(torch.unique_consecutive(
        flat * x.element_size() // SECTOR).numel()) * SECTOR


def bound(name: str, args, kw) -> tuple[float, str, int, int]:
    """The least time the card could take for one call on these inputs:
    the larger of the bytes the function must move over the HBM rate and
    its operations over the float32 rate.  Masks and statuses are read
    whole; an input the mask gates counts only the 32-byte sectors that
    hold a selected element; each output is written once.  Operations:
    one compare per selected cell (Min-Min and Max-Min add one add per
    pair, Max-Min one compare per waiting task).
    Returns (ms, "bytes" or "operations", bytes, operations)."""
    args = [a.contiguous() if isinstance(a, torch.Tensor) else a
            for a in args]
    if name == "masked_argmin":
        values, mask = args
        r = values.shape[0]
        moved = nbytes(mask) + sector_bytes(values, mask) + r * 8
        ops = int(mask.sum())
    elif name in ("fused_minmin", "fused_maxmin"):
        avail, in_batch, room, type_id, eet_m = args
        r, t = eet_m.shape[:2]
        live = in_batch.any(1) & room.any(1)           # replicas with pairs
        tasks = in_batch & live[:, None]
        used = torch.zeros((r, t), dtype=torch.int32, device=avail.device)
        used.scatter_add_(1, type_id.long(), tasks.to(torch.int32))
        cols = room & live[:, None]
        moved = (nbytes(in_batch, room) + sector_bytes(avail, cols)
                 + sector_bytes(type_id, tasks)
                 + sector_bytes(eet_m, (used > 0)[:, :, None]
                                & cols[:, None, :])
                 + r * (8 if name == "fused_minmin" else 12))
        # an add and a compare per valid pair (Max-Min: and one compare
        # per waiting task for the argmax)
        ops = 2 * int((tasks.sum(1) * cols.sum(1)).sum())
        if name == "fused_maxmin":
            ops += int(tasks.sum())
    elif name == "fused_start_pick":
        status, machine, seq, n_machines = args
        queued = status == kw["in_mq"]
        moved = (nbytes(status) + sector_bytes(machine, queued)
                 + sector_bytes(seq, queued)
                 + status.shape[0] * n_machines * (4 + 1))   # pick, has
        ops = int(queued.sum())
    else:
        status, arrival, deadline = args
        waiting = status == kw["not_arrived"]
        live = (status >= kw["live_lo"]) & (status <= kw["live_hi"])
        moved = (nbytes(status) + sector_bytes(arrival, waiting)
                 + sector_bytes(deadline, live) + status.shape[0] * 8)
        ops = int(waiting.sum() + live.sum())
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    if by_ops > by_bytes:
        return by_ops, "operations", moved, ops
    return by_bytes, "bytes", moved, ops


def timings(K, KREF, launches, captured, errs, paths=PATHS) -> list:
    """One kernels-JSON row per scheduling kernel; ``launches`` and
    ``captured`` map each sweep path to its counts and captured inputs."""
    rows = []
    for name in K.NAMES:
        caps = [(f"{path} {call}", args, kw) for path in paths
                for call, args, kw in captured[path][name]]
        if not caps:
            raise AssertionError(f"no captured main-path input for {name}")
        # the captured call with the most work: the bound and the times
        # then describe the kernel under load, not an empty queue
        call, args, kw = max(caps, key=lambda c: bound(name, c[1], c[2])[3])
        kernel = getattr(K, name)
        plain = getattr(KREF, name + "_ref")
        saved = dict(K.launches)
        sets = cold_sets(args)
        stream_ms = time_ms(kernel, sets, kw)
        plain_stream_ms = time_ms(plain, sets, kw)
        ms = device_ms(kernel, sets, kw)
        plain_ms = device_ms(plain, sets, kw)
        del sets
        K.launches.update(saved)
        if ms <= 0.0 or plain_ms <= 0.0:
            raise AssertionError(f"{name}: the profiler saw no device time")
        bound_ms, bound_by, moved, ops = bound(name, args, kw)
        shape = ", ".join("x".join(map(str, a.shape)) for a in args
                          if isinstance(a, torch.Tensor))
        log("6 timings", f"{name} at the main path's {shape} (call {call}), "
            f"inputs cold in L2: "
            f"device time per call (profiler) kernel {ms:.5f} ms, plain "
            f"{plain_ms:.5f} ms; stream time per call (CUDA events) kernel "
            f"{stream_ms:.5f} ms, plain {plain_stream_ms:.5f} ms; bound "
            f"{bound_ms:.5f} ms by {bound_by} ({moved} bytes, {ops} "
            f"operations); {gpu_line()}")
        rows.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                     "replaces": REPLACES[name],
                     "launches": sum(launches[p][name] for p in paths),
                     **{f"launches_{p}": launches[p][name] for p in paths},
                     "max_abs_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     "stream_ms": stream_ms,
                     "plain_stream_ms": plain_stream_ms})
    return rows


def profile_window(X, E, K, dev, path, n_rep, n_tasks, n_mach, steps=32):
    """A main path's first ``steps`` event steps at full width, under
    the profiler: wall time, device busy/idle share, top device kernels,
    and the port's kernels' device time per call in that window."""
    from torch.profiler import ProfilerActivity, profile
    phase = f"4 {path} profile"
    spec = make_spec(X, E, path, n_rep, n_tasks, n_mach, max_events=steps)
    reps = X.normalize(spec, device=dev)
    X.run_experiment(spec, device=dev, replicas=reps)      # warm-up
    torch.cuda.synchronize()
    saved = dict(K.launches)
    stats = E.RunStats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        X.run_experiment(spec, device=dev, replicas=reps, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    K.launches.update(saved)
    spans = device_activity(prof)
    busy = busy_us(spans) / 1e6
    log(phase, f"{stats.events} event steps, {stats.drain_trips} drain "
        f"trips, {stats.host_reads} host reads: wall {wall:.3f} s, device "
        f"busy {busy:.3f} s ({100 * busy / wall:.1f}%, idle "
        f"{100 * (1 - busy / wall):.1f}%), {len(spans)} device activities "
        f"({len(spans) / max(stats.events, 1):.0f} per event step); "
        f"{gpu_line()}")
    by_name: dict = {}
    for name, s, e in spans:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + e - s, cnt + 1)
    for name, (tot, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:8]:
        log(phase, f"{tot / 1e3:10.2f} ms {cnt:7d} x  {name[:90]}")
    for kname in K.NAMES:
        hits = [(t, c) for n, (t, c) in by_name.items()
                if kname + "_kernel" in n]
        if hits:
            t, c = hits[0]
            log(phase, f"in the main path: {kname}_kernel {c} calls, "
                f"{t / c / 1e3:.5f} ms device time each")


# ---------------------------------------------------------------------------
# model kernels: flash attention and the grouped matmul
# ---------------------------------------------------------------------------
MODEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                atol: float, rtol: float) -> float:
    """Raise unless ``got`` is close to ``want``; returns the largest
    absolute difference."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} != "
                             f"{want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.allclose(g, w, atol=atol, rtol=rtol):
        bad = (~torch.isclose(g, w, atol=atol, rtol=rtol)).nonzero()[:5]
        raise AssertionError(f"{name}: kernel not within atol {atol} rtol "
                             f"{rtol} of plain at {bad.tolist()}")
    return float((g - w).abs().max()) if g.numel() else 0.0


def check_model_call(mods, name: str, args, kw, label: str) -> float:
    """One model-kernel call against its plain version, at the stated
    tolerance; grouped-matmul rows past the size must be exactly 0."""
    mod = mods[name]
    got = getattr(mod, name)(*args, **kw)
    torch.cuda.synchronize()
    want = getattr(mod, name + "_ref")(*args, **kw)
    tol = MODEL_TOL[args[0].dtype]
    if name == "flash_attention":
        return check_close(f"{name} {label}", got, want, tol, tol)
    lhs, _, sizes = args
    err = check_close(f"{name} {label}", got, want, tol * lhs.shape[2], tol)
    pad = torch.arange(lhs.shape[1], device=lhs.device)[None, :] \
        >= sizes[:, None]
    if not bool((got[pad] == 0).all()):
        raise AssertionError(f"{name} {label}: a padding row is not 0")
    return err


def model_kernel_cases(dev):
    """(name, label, args, kwargs) cases of the two model kernels."""
    g = torch.Generator(device="cpu").manual_seed(2)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = "f32" if dtype == torch.float32 else "bf16"

        def rnd(*shape):
            return torch.randn(shape, generator=g).to(dev, dtype)
        for bh, sq, sk, hd, kw, what in (
                (3, 128, 128, 64, {"causal": True}, "causal"),
                (3, 130, 130, 128, {"causal": True}, "ragged S"),
                (2, 64, 256, 128, {"causal": False}, "non-causal Sq<Sk"),
                (2, 200, 77, 64, {"causal": True}, "causal Sq>Sk"),
                (3, 37, 53, 16, {"causal": True}, "odd shapes"),
                (2, 256, 256, 256, {"causal": True}, "hd 256"),
                (2, 192, 192, 32, {"causal": True, "window": 64}, "window"),
                (2, 100, 100, 128, {"causal": False, "window": 30},
                 "non-causal window"),
                (2, 64, 64, 32, {"causal": True, "softcap": 20.0},
                 "softcap"),
                (2, 96, 32, 32, {"causal": True, "window": 16},
                 "rows with no visible key"),
                (12, 1024, 1024, 128, {"causal": True},
                 "qwen2-1.5b prefill shape")):
            cases.append(("flash_attention", f"{dn} {what} {bh}x{sq}x{sk}x"
                          f"{hd}", (rnd(bh, sq, hd), rnd(bh, sk, hd),
                                    rnd(bh, sk, hd)), kw))
        for gr, c, d, f, sizes, what in (
                (4, 40, 96, 72, [0, 13, 40, 1], "sizes 0, partial, full"),
                (8, 128, 64, 128, [128, 0, 64, 65, 1, 127, 3, 0],
                 "tile edges"),
                (3, 33, 48, 40, [33, 0, 17], "C, F not tile multiples"),
                (4, 32, 16, 24, [0, 0, 0, 0], "all groups empty"),
                (64, 8, 2048, 200, [1 if i % 11 == 0 else 0
                                    for i in range(64)],
                 "decode-like, 6 live groups")):
            sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
            cases.append(("grouped_matmul", f"{dn} {what} {gr}x{c}x{d}x{f}",
                          (rnd(gr, c, d), rnd(gr, d, f), sz), {}))
    return cases


def check_model_kernels(mods, dev) -> dict:
    errs = dict.fromkeys(MODEL_KERNELS, 0.0)
    for name, label, args, kw in model_kernel_cases(dev):
        errs[name] = max(errs[name],
                         check_model_call(mods, name, args, kw, label))
        log("3 kernels", f"{name} {label}: within tolerance, max abs err "
            f"{errs[name]:.3g}")
    return errs


def model_bound(name: str, args, kw) -> tuple[float, str, int, int]:
    """The least time the card could take for one call on these inputs,
    the larger of bytes over the HBM rate and operations over the
    float32 rate (67 TFLOP/s: both kernels compute in f32).
    flash_attention: 4 * BH * hd operations per visible (q, k) pair;
    q, k, v read once and o written once.  grouped_matmul: 2 * D * F
    operations per live row; the live groups' rhs, the live rows of lhs
    and the sizes read once, the whole output written once.
    Returns (ms, "bytes" or "operations", bytes, operations)."""
    if name == "flash_attention":
        from repro_torch.kernels.flash_attention import visible_mask
        q, k, v = args
        pairs = int(visible_mask(q.shape[1], k.shape[1],
                                 causal=kw.get("causal", True),
                                 window=kw.get("window", 0),
                                 device=q.device).sum())
        ops = 4 * q.shape[0] * q.shape[2] * pairs
        moved = 2 * nbytes(q) + nbytes(k, v)
    else:
        lhs, rhs, sizes = args
        g, c, d = lhs.shape
        f = rhs.shape[2]
        live = torch.clamp(sizes.long(), 0, c)
        rows = int(live.sum())
        ops = 2 * rows * d * f
        moved = (int((live > 0).sum()) * d * f * rhs.element_size()
                 + rows * d * lhs.element_size() + nbytes(sizes)
                 + g * c * f * lhs.element_size())
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    if by_ops > by_bytes:
        return by_ops, "operations", moved, ops
    return by_bytes, "bytes", moved, ops


def library_call(name: str, kw):
    """One PyTorch call computing the same function, or None."""
    if name == "grouped_matmul":
        # the MoE buffers' padding rows are zero, so bmm agrees there
        return lambda lhs, rhs, sizes: torch.bmm(lhs, rhs)
    if kw.get("causal", True) and not kw.get("window") \
            and not kw.get("softcap"):
        import torch.nn.functional as F
        return lambda q, k, v, **_: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)
    return None


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------
SERVE_EET = np.array([[1.0, 2.0], [3.0, 1.5]], np.float32)  # type x mtype
SERVE_POWER = np.array([[50.0, 200.0], [30.0, 120.0]], np.float32)
SERVE_MTYPES = (0, 0, 1, 1)


def serve_archs(tiny: bool):
    """qwen2-1.5b as published and deepseek-moe-16b at its published
    widths cut to 8 layers (1 dense + 7 MoE); their tiny forms."""
    from repro_torch.configs.base import get_arch
    qwen, ds = get_arch("qwen2-1.5b"), get_arch("deepseek-moe-16b")
    if tiny:
        return qwen.tiny(), ds.tiny()
    return qwen, dataclasses.replace(ds, n_layers=8)


def serve_apps(cfgs, dev, prompt_len, gen_len):
    from repro_torch.models import model as M
    from repro_torch.serving import AppSpec
    apps = []
    for seed, cfg in enumerate(cfgs):
        params = M.init_params(torch.Generator(dev).manual_seed(seed), cfg)
        apps.append(AppSpec(cfg.name, gen_len=gen_len, arch=cfg,
                            params=params, prompt_len=prompt_len))
    return apps


def serve_workload(n: int, seed: int = 0):
    from repro_torch.core.workload import poisson_workload
    wl = poisson_workload(n, rate=0.5, n_task_types=2,
                          mean_eet=SERVE_EET.mean(1), slack=60.0,
                          seed=seed)
    if set(wl.type_id.tolist()) != {0, 1}:
        raise AssertionError("the serving workload lacks a task type")
    return wl


def n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(n_params(v) for v in tree)
    return tree.numel()


def expected_launches(apps, type_ids) -> dict:
    """Launches the shapes imply: one flash attention per layer of a
    prefill, two grouped matmuls per MoE layer of a prefill and of each
    of the ``gen_len`` decode steps."""
    out = dict.fromkeys(MODEL_KERNELS, 0)
    for t in type_ids:
        app = apps[int(t)]
        kinds = app.arch.kinds()
        out["flash_attention"] += len(kinds)
        out["grouped_matmul"] += 2 * kinds.count("moe") * (1 + app.gen_len)
    return out


@contextlib.contextmanager
def serve_hooks(M, mods):
    """Within the block: the synchronised host time of every ``prefill``
    and ``decode_step`` by model name, and the inputs of the first call
    of each input shape of the two model kernels, in
    ``{name: [(call, args, kwargs), ...]}``.  The inputs are held, not
    copied: the port writes none of them after the call."""
    times: dict = {}
    captured = {name: [] for name in MODEL_KERNELS}
    orig = {"prefill": M.prefill, "decode_step": M.decode_step}
    kernels = {name: getattr(mods[name], name) for name in MODEL_KERNELS}

    def timed(kind, fn, cfg_at):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times.setdefault(args[cfg_at].name, {"prefill": [],
                                                 "decode_step": []})[
                kind].append(time.perf_counter() - t0)
            return out
        return wrapped

    def capture(name, fn):
        seen, count = set(), [0]

        def wrapped(*args, **kw):
            count[0] += 1
            key = tuple(tuple(a.shape) for a in args
                        if isinstance(a, torch.Tensor)) \
                + tuple(sorted(kw.items()))
            if key not in seen:
                seen.add(key)
                captured[name].append((count[0], args, dict(kw)))
            return fn(*args, **kw)
        return wrapped

    M.prefill = timed("prefill", orig["prefill"], 2)
    M.decode_step = timed("decode_step", orig["decode_step"], 3)
    for name, fn in kernels.items():
        setattr(mods[name], name, capture(name, fn))
    try:
        yield times, captured
    finally:
        M.prefill, M.decode_step = orig["prefill"], orig["decode_step"]
        for name, fn in kernels.items():
            setattr(mods[name], name, fn)


def run_serve(mods, dev, tiny: bool, n_requests: int = 8):
    """Drive the serving path once through ``ServingEngine.run``, the
    model kernels' launch counts set to 0 just before and read just
    after; returns the apps, the launches and the captured inputs."""
    from repro_torch.models import model as M
    from repro_torch.serving import ServeConfig, ServingEngine
    phase = "4 serve"
    prompt_len, gen_len = (40, 6) if tiny else (1024, 32)
    cfgs = serve_archs(tiny)
    t0 = time.perf_counter()
    apps = serve_apps(cfgs, dev, prompt_len, gen_len)
    torch.cuda.synchronize()
    for app in apps:
        log(phase, f"{app.name}: {app.arch.n_layers} layers "
            f"({', '.join(sorted(set(app.arch.kinds())))}), d "
            f"{app.arch.d_model}, heads {app.arch.n_heads}/"
            f"{app.arch.n_kv_heads} x {app.arch.hd}, vocab "
            f"{app.arch.vocab_size}: {n_params(app.params) / 1e9:.3f} B "
            f"parameters in f32")
    log(phase, f"weights drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    wl = serve_workload(n_requests)
    engine = ServingEngine(SERVE_EET, SERVE_POWER, list(SERVE_MTYPES), apps,
                           ServeConfig(policy="ee_mct", run_mode="real"),
                           device=dev)
    torch.cuda.reset_peak_memory_stats()
    with serve_hooks(M, mods) as (times, captured):
        for mod in mods.values():
            mod.reset_launches()
        t0 = time.perf_counter()
        rep = engine.run(wl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: mods[name].launches[name]
                    for name in MODEL_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(phase, json.dumps(rep.row()))
    log(phase, f"{rep.completed} of {rep.n_requests} requests completed, "
        f"{rep.tokens_generated} tokens generated in {wall:.3f} s "
        f"(synchronised); peak device memory {peak:.2f} GiB; {gpu_line()}")
    for app in apps:
        t = times.get(app.name)
        if t is None:
            raise AssertionError(f"{app.name} served no request")
        log(phase, f"{app.name}: prefill {1e3 * np.mean(t['prefill']):.2f} "
            f"ms a request over {len(t['prefill'])} requests of "
            f"{prompt_len} tokens, decode "
            f"{1e3 * np.mean(t['decode_step']):.3f} ms a token over "
            f"{len(t['decode_step'])} steps (synchronised)")
    want = expected_launches(apps, wl.type_id)
    log(phase, f"kernel launches {json.dumps(launches)}, implied by the "
        f"shapes {json.dumps(want)}")
    if rep.completed != rep.n_requests or len(engine.outputs) \
            != rep.n_requests:
        raise AssertionError(f"{rep.completed} of {rep.n_requests} requests "
                             "completed")
    if rep.tokens_generated != sum(apps[t].gen_len for t in wl.type_id):
        raise AssertionError("tokens generated != the requests' decode "
                             "lengths")
    for task, toks in engine.outputs.items():
        vocab = apps[int(wl.type_id[task])].arch.vocab_size
        if toks.shape != (gen_len,) or not ((toks >= 0)
                                            & (toks < vocab)).all():
            raise AssertionError(f"request {task}: tokens {toks}")
    if launches != want:
        raise AssertionError(f"launches {launches} != implied {want}")
    return apps, launches, captured


def recheck_model_captured(mods, captured) -> dict:
    errs = dict.fromkeys(MODEL_KERNELS, 0.0)
    for name in MODEL_KERNELS:
        for call, args, kw in captured[name]:
            shape = "x".join(map(str, args[0].shape))
            err = check_model_call(mods, name, args, kw,
                                   f"serve call {call} ({shape})")
            errs[name] = max(errs[name], err)
            log("3 kernels", f"{name} captured at serve-path call {call} "
                f"({shape}): within tolerance, max abs err {err:.3g}")
    return errs


def profile_serve(mods, apps, dev) -> dict:
    """One request of each app under the profiler: wall time, device
    busy/idle share, the top device kernels, and each model kernel's
    device time per call inside the run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.workload import Workload
    from repro_torch.serving import ServeConfig, ServingEngine
    phase = "4 serve profile"
    wl = Workload(np.array([0.0, 0.1], np.float32), np.array([0, 1]),
                  np.array([1e6, 1e6], np.float32))
    engine = ServingEngine(SERVE_EET, SERVE_POWER, list(SERVE_MTYPES), apps,
                           ServeConfig(policy="ee_mct", run_mode="real"),
                           device=dev)
    saved = {name: dict(mods[name].launches) for name in MODEL_KERNELS}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(wl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for name in MODEL_KERNELS:
        mods[name].launches.update(saved[name])
    spans = device_activity(prof)
    busy = busy_us(spans) / 1e6
    log(phase, f"one request of each app: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s ({100 * busy / wall:.1f}%, idle "
        f"{100 * (1 - busy / wall):.1f}%), {len(spans)} device activities; "
        f"{gpu_line()}")
    by_name: dict = {}
    for name, s, e in spans:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + e - s, cnt + 1)
    for name, (tot, cnt) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:10]:
        log(phase, f"{tot / 1e3:10.2f} ms {cnt:7d} x  {name[:90]}")
    in_run = {}
    for kname in MODEL_KERNELS:
        hits = [(t, c) for n, (t, c) in by_name.items()
                if kname + "_kernel" in n]
        if not hits:
            raise AssertionError(f"the profiler saw no {kname}_kernel")
        t, c = sum(h[0] for h in hits), sum(h[1] for h in hits)
        in_run[kname] = t / c / 1e3
        log(phase, f"in the main path: {kname}_kernel {c} calls, "
            f"{in_run[kname]:.5f} ms device time each")
    return in_run


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


@contextlib.contextmanager
def recording(M, force=None):
    """Within the block, every ``prefill`` and ``decode_step`` appends
    (kind, input tokens, f32 logits on the CPU) to the yielded list, in
    call order.  With ``force`` (an earlier recording) each
    ``decode_step`` takes that run's input token instead of its own:
    teacher forcing."""
    calls = []
    orig_p, orig_d = M.prefill, M.decode_step

    def prefill(*args, **kw):
        logits, cache = orig_p(*args, **kw)
        calls.append(("prefill", None, logits.float().cpu()))
        return logits, cache

    def decode_step(params, cache, tokens, *args, **kw):
        if force is not None:
            kind, forced, _ = force[len(calls)]
            if kind != "decode_step":
                raise AssertionError("card and CPU runs called the model "
                                     "in another order")
            tokens = forced.to(tokens.device)
        logits, cache = orig_d(params, cache, tokens, *args, **kw)
        calls.append(("decode_step", tokens.cpu(), logits.float().cpu()))
        return logits, cache

    M.prefill, M.decode_step = prefill, decode_step
    try:
        yield calls
    finally:
        M.prefill, M.decode_step = orig_p, orig_d


def serve_card_vs_cpu(dev) -> None:
    """The tiny apps through the same ``ServingEngine`` on the CPU and on
    the card, the card teacher-forced with the CPU's tokens."""
    from repro_torch.models import model as M
    from repro_torch.serving import AppSpec, ServeConfig, ServingEngine
    cfgs = serve_archs(tiny=True)
    cpu_params = [M.init_params(torch.Generator().manual_seed(i), c)
                  for i, c in enumerate(cfgs)]
    wl = serve_workload(5, seed=1)
    runs = {}
    for where, params in (("cpu", cpu_params),
                          ("card", [tree_to(p, dev) for p in cpu_params])):
        apps = [AppSpec(c.name, gen_len=6, arch=c, params=p, prompt_len=40)
                for c, p in zip(cfgs, params)]
        engine = ServingEngine(SERVE_EET, SERVE_POWER, list(SERVE_MTYPES),
                               apps, ServeConfig(policy="ee_mct",
                                                 run_mode="real"),
                               device="cpu" if where == "cpu" else dev)
        with recording(M, force=runs.get("cpu")) as calls:
            engine.run(wl)
        runs[where] = calls
    if len(runs["card"]) != len(runs["cpu"]):
        raise AssertionError("card and CPU ran different numbers of steps")
    err, compared = 0.0, 0
    for i, ((kind, _, want), (_, _, got)) in enumerate(zip(runs["cpu"],
                                                          runs["card"])):
        err = max(err, check_close(f"tiny serving {kind} {i}", got, want,
                                   1e-4, 1e-4))
        top2 = torch.topk(want[0, -1], 2).values
        if float(top2[0] - top2[1]) > 1e-3:
            compared += 1
            if int(got[0, -1].argmax()) != int(want[0, -1].argmax()):
                raise AssertionError(f"tiny serving {kind} {i}: greedy "
                                     "token differs")
    log("5 card=cpu", f"tiny qwen2-1.5b + deepseek-moe-16b serving, 5 "
        f"requests, {len(runs['cpu'])} model calls teacher-forced: every "
        f"logit within 1e-4 of the CPU's (max abs err {err:.3g}), greedy "
        f"tokens equal at all {compared} steps with a top-2 margin > 1e-3")


def model_timings(mods, launches, captured, errs, in_run) -> list:
    """One kernels-JSON row per model kernel, timed on its captured call
    with the most work; every captured call is timed and logged."""
    rows = []
    for name in MODEL_KERNELS:
        mod = mods[name]
        kernel, plain = getattr(mod, name), getattr(mod, name + "_ref")
        results = []
        for call, args, kw in captured[name]:
            saved = dict(mod.launches)
            sets = cold_sets(args)
            lib = library_call(name, kw)
            res = {"call": call, "stream_ms": time_ms(kernel, sets, kw),
                   "ms": device_ms(kernel, sets, kw),
                   "plain_ms": device_ms(plain, sets, kw),
                   "library_ms": None if lib is None
                   else device_ms(lib, sets, kw)}
            del sets
            mod.launches.update(saved)
            if res["ms"] <= 0.0 or res["plain_ms"] <= 0.0:
                raise AssertionError(f"{name}: the profiler saw no device "
                                     "time")
            res["bound_ms"], res["bound_by"], moved, ops = model_bound(
                name, args, kw)
            shape = ", ".join("x".join(map(str, a.shape)) for a in args)
            lib_s = "n/a" if res["library_ms"] is None \
                else f"{res['library_ms']:.5f} ms"
            log("6 timings", f"{name} at the serve path's {shape} {kw} "
                f"(call {call}), inputs cold in L2: device time per call "
                f"(profiler) kernel {res['ms']:.5f} ms, plain "
                f"{res['plain_ms']:.5f} ms, library {lib_s}; stream time "
                f"kernel {res['stream_ms']:.5f} ms; bound "
                f"{res['bound_ms']:.5f} ms by {res['bound_by']} ({moved} "
                f"bytes, {ops} operations); {gpu_line()}")
            results.append((ops, res))
        if not results:
            raise AssertionError(f"no captured main-path input for {name}")
        res = max(results, key=lambda r: r[0])[1]
        rows.append({"name": name, "route": "cuda",
                     "source": MODEL_SOURCE.format(name),
                     "replaces": REPLACES[name],
                     "launches": launches[name], "launches_serve":
                     launches[name], "max_abs_err": errs[name],
                     "ms": res["ms"], "plain_ms": res["plain_ms"],
                     "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"],
                     "library_ms": res["library_ms"],
                     "stream_ms": res["stream_ms"],
                     "in_run_ms": in_run[name]})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=4096,
                    help="replicas of the scenario path")
    ap.add_argument("--flat-replicas", type=int, default=4096,
                    help="replicas of the flat path")
    ap.add_argument("--tasks", type=int, default=1024)
    ap.add_argument("--machines", type=int, default=32)
    ap.add_argument("--paths", default=",".join(ALL_PATHS),
                    help="comma-separated main paths to drive (a short "
                    "call may drive fewer; the full check drives all)")
    ap.add_argument("--serve-tiny", action="store_true",
                    help="serve the apps' tiny configurations (prompt 40, "
                    "6 tokens) instead of the full-width ones")
    a = ap.parse_args()
    paths = [p for p in a.paths.split(",") if p]
    if not set(paths) <= set(ALL_PATHS):
        ap.error(f"--paths takes {ALL_PATHS}")
    sweeps = [p for p in PATHS if p in paths]
    width = {"flat": a.flat_replicas, "scenario": a.replicas}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    # products outside the kernels (projections, MLPs, unembedding) stay
    # in full f32, which the model tolerances assume
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import engine as E
    from repro_torch.core import state as S
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import grouped_matmul as GMM
    from repro_torch.kernels import ref as KREF
    from repro_torch.kernels import sched_argmin as K
    from repro_torch.launch import experiment as X
    mods = {"flash_attention": FA, "grouped_matmul": GMM}

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = gpu_line()
    log("1 device", f"{name} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; TF32 off for "
        f"matmul and cuDNN")
    print(card, flush=True)

    t0 = time.perf_counter()
    build.build_all()
    log("2 build", f"{len(build.LIBRARIES)} libraries, one nvcc each in "
        f"parallel, {time.perf_counter() - t0:.1f} s")
    for lib, meta in build.info.items():
        log("2 build", f"{os.path.basename(meta['library'])} in "
            f"{meta['seconds']:.1f} s "
            f"({' '.join(build.LIBRARIES[lib]['flags'])})")
        for line in meta.get("log", "").splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print("    " + line.strip())

    errs = check_kernels(K, KREF, dev)
    errs.update(check_model_kernels(mods, dev))
    launches, captured = {}, {}
    for path in sweeps:
        res, launches[path], captured[path] = run_main(
            X, E, K, S, dev, path, width[path], a.tasks, a.machines)
        del res
        recheck_captured(K, KREF, captured[path], path)
    rows = []
    if "serve" in paths:
        apps, serve_launches, serve_captured = run_serve(mods, dev,
                                                         a.serve_tiny)
        for kname, err in recheck_model_captured(mods,
                                                 serve_captured).items():
            errs[kname] = max(errs[kname], err)
        in_run = profile_serve(mods, apps, dev)
        del apps
        torch.cuda.empty_cache()
    for path in sweeps:
        profile_window(X, E, K, dev, path, width[path], a.tasks, a.machines)
    for path in sweeps:
        card_vs_cpu(X, E, dev, path)
    if "serve" in paths:
        serve_card_vs_cpu(dev)
    if sweeps:
        rows += timings(K, KREF, launches, captured, errs, sweeps)
    if "serve" in paths:
        rows += model_timings(mods, serve_launches, serve_captured, errs,
                              in_run)
    log("done", f"{time.perf_counter() - t_all:.1f} s")
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
