"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full check, one card

    python3 chip_smoke.py --replicas 512 --flat-replicas 512   # short

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device: the card's name and power limit;
  2. build: nvcc builds the CUDA kernels from ``src/repro_torch/kernels``;
  3. kernels: each kernel against its plain PyTorch version on the card,
     bitwise, on random and edge-case inputs;
  4. main paths, each driven through ``run_experiment`` with the launch
     counts set to 0 just before it and read just after, every kernel
     launched, every task terminal, and kernel inputs captured from the
     run re-checked against the plain versions:
       flat      4096 replicas x 1024 tasks x 32 machines, ten policies;
       scenario  the same width with a ``ScenarioAxis`` (fail rates 0,
                 0.05, 0.1 x DVFS nominal, powersave, turbo, half the
                 replicas on spot machines), ten policies;
  5. card vs CPU: a 64 x 128 x 8 flat sweep and scenario sweep on the
     card and on the CPU must give bitwise-equal final states and
     summaries;
  6. timings: each kernel and its plain version on the inputs of the
     captured main-path call with the most work, rotated over copies
     larger than the L2 cache: device time (profiler) and stream time
     (CUDA events), beside the least time the card could take for that
     call's data (see ``bound``).
After 4 a profiled window of each path's first 32 event steps gives the
device's busy and idle share.
The last two lines are the kernels JSON line and the result line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")
SCENARIO = dict(fail_rates=(0.0, 0.05, 0.1),
                dvfs_states=("nominal", "powersave", "turbo"),
                spot_frac=0.5)
PATHS = ("flat", "scenario")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SECTOR = 32                   # bytes the memory system moves at least
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/sched_argmin.cu"
REPLACES = {
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


def timings(K, KREF, launches, captured, errs) -> list:
    """One kernels-JSON row per kernel; ``launches`` and ``captured``
    map each main path to its counts and captured inputs."""
    rows = []
    for name in K.NAMES:
        caps = [(f"{path} {call}", args, kw) for path in PATHS
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
                     "launches": sum(launches[p][name] for p in PATHS),
                     **{f"launches_{p}": launches[p][name] for p in PATHS},
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=4096,
                    help="replicas of the scenario path")
    ap.add_argument("--flat-replicas", type=int, default=4096,
                    help="replicas of the flat path")
    ap.add_argument("--tasks", type=int, default=1024)
    ap.add_argument("--machines", type=int, default=32)
    a = ap.parse_args()
    width = {"flat": a.flat_replicas, "scenario": a.replicas}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.core import engine as E
    from repro_torch.core import state as S
    from repro_torch.kernels import build
    from repro_torch.kernels import ref as KREF
    from repro_torch.kernels import sched_argmin as K
    from repro_torch.launch import experiment as X

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = gpu_line()
    log("1 device", f"{name} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    print(card, flush=True)

    build.load()
    log("2 build", f"{os.path.basename(build.info['library'])} in "
        f"{build.info['seconds']:.1f} s ({' '.join(build.NVCC_FLAGS)})")
    for line in build.info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "entry" in line:
            print("    " + line.strip())

    errs = check_kernels(K, KREF, dev)
    launches, captured = {}, {}
    for path in PATHS:
        res, launches[path], captured[path] = run_main(
            X, E, K, S, dev, path, width[path], a.tasks, a.machines)
        del res
        recheck_captured(K, KREF, captured[path], path)
    for path in PATHS:
        profile_window(X, E, K, dev, path, width[path], a.tasks, a.machines)
    for path in PATHS:
        card_vs_cpu(X, E, dev, path)
    rows = timings(K, KREF, launches, captured, errs)
    log("done", f"{time.perf_counter() - t_all:.1f} s")
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
