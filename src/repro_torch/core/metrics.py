"""In-loop telemetry, batched over replicas: latency histograms and
windowed SLO monitors.

The counterpart of ``repro.core.metrics``.  A histogram is a ``(R,
buckets + 2)`` int32 counts tensor over log-spaced buckets between
``lo`` and ``hi`` (bin 0 the underflow ``[0, lo)``, bin ``B + 1`` the
overflow ``[hi, inf)``); the SLO windows count completions, deadline
misses and over-target responses per fixed window of simulated time.

Only the queue-depth sample exists per event (``observe_event``, one
scatter-add a step, on the replicas that processed an event); the
per-task samples fold once over the final task table (``fold_tasks``),
as in the reference, since every task reaches one terminal state with
final times.  The bucket edges are computed in float64 on the host and
cast once to float32, so the port, the reference and the numpy twin
``fold_tasks_np`` bucket against bit-identical edges.

``quantiles`` (also ``quantiles_jnp``, the reference's name) is the
device twin of :func:`hist_quantile`, batched over R: the tail columns
of ``launch/experiment.py`` (:func:`tail_columns`) come from it
without a host read.
:func:`percentile` is the exact host percentile behind the serving
report's tails.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import state as S
from repro_torch.core.reduce import fma


class MetricsSpec(NamedTuple):
    """Instrument geometry (hashable, as the reference's)."""

    buckets: int = 32         # log-spaced buckets between lo and hi
    lo: float = 1e-2          # smallest resolved value (s, or tasks)
    hi: float = 1e3           # largest resolved value
    slo_target: float = float("inf")   # response-time SLO target (s)
    windows: int = 8          # number of wall-clock SLO windows
    window_s: float = 16.0    # width of each window (s); later events
    #                           clip into the last window


DEFAULT_SPEC = MetricsSpec()

#: histogram fields of :class:`SimMetrics`, in order
HIST_KEYS = ("response", "wait", "slowdown", "queue_depth")
#: windowed SLO counter fields, in order
WINDOW_KEYS = ("win_done", "win_miss", "win_over")

_EPS = np.float32(1e-6)


def bucket_edges(spec: MetricsSpec) -> np.ndarray:
    """(B + 1,) float32 log-spaced bucket edges, computed in float64 and
    cast once."""
    return np.geomspace(spec.lo, spec.hi,
                        spec.buckets + 1).astype(np.float32)


def bucket_bounds(spec: MetricsSpec) -> tuple[np.ndarray, np.ndarray]:
    """(lows, highs), each (B + 2,): the value range of every counts bin
    including underflow ([0, lo)) and overflow (collapsed to hi)."""
    edges = bucket_edges(spec).astype(np.float64)
    lows = np.concatenate([[0.0], edges])
    highs = np.concatenate([edges, [edges[-1]]])
    return lows, highs


@dataclasses.dataclass
class SimMetrics(S._Batched):
    """Instrument state of R replicas; ``spec`` is shared."""

    spec: MetricsSpec         # bucket/window geometry
    response: torch.Tensor    # i32 (R, B+2) response time of completions
    wait: torch.Tensor        # i32 (R, B+2) wait (t_start - arrival) of
    #                           tasks that ever started
    slowdown: torch.Tensor    # i32 (R, B+2) response / service
    queue_depth: torch.Tensor  # i32 (R, B+2) tasks waiting, per event
    win_done: torch.Tensor    # i32 (R, K) completions per SLO window
    win_miss: torch.Tensor    # i32 (R, K) deadline misses per window
    win_over: torch.Tensor    # i32 (R, K) completions over slo_target

    _FIELDS = HIST_KEYS + WINDOW_KEYS


def init(spec: MetricsSpec | None, n_replicas: int, device) -> SimMetrics:
    """Zeroed instruments for ``n_replicas`` replicas on ``device``."""
    spec = spec or DEFAULT_SPEC

    def zeros(width):
        return torch.zeros((n_replicas, width), dtype=torch.int32,
                           device=device)

    hist = [zeros(spec.buckets + 2) for _ in HIST_KEYS]
    win = [zeros(spec.windows) for _ in WINDOW_KEYS]
    return SimMetrics(spec, *hist, *win)


# ---------------------------------------------------------------------------
# Accumulation on the device
# ---------------------------------------------------------------------------
def _bucket(spec: MetricsSpec, x: torch.Tensor,
            edges: torch.Tensor | None = None) -> torch.Tensor:
    """Counts-bin index of float32 samples ``x``: 0 underflow, B + 1
    overflow.  ``edges``: the spec's ``bucket_edges`` already on
    ``x``'s device (copied here otherwise, a copy that waits for the
    host)."""
    if edges is None:
        edges = torch.as_tensor(bucket_edges(spec), device=x.device)
    return torch.searchsorted(edges, x.to(torch.float32).contiguous(),
                              right=True).to(torch.int32)


def _add(counts: torch.Tensor, idx: torch.Tensor, on: torch.Tensor
         ) -> torch.Tensor:
    """``counts`` (R, W) plus one at ``idx[r, j]`` wherever ``on[r, j]``."""
    w = counts.shape[1]
    ext = torch.cat([counts, torch.zeros_like(counts[:, :1])], 1)
    ext.scatter_add_(1, torch.where(on, idx, w).long(),
                     torch.ones_like(idx, dtype=torch.int32))
    return ext[:, :w].contiguous()


def observe_event(mt: SimMetrics, tasks: S.TaskTable,
                  act: torch.Tensor) -> None:
    """In place: one queue-depth sample (tasks in the batch and machine
    queues at the end of the event) for the replicas ``act`` that
    processed an event."""
    depth = ((tasks.status == S.IN_BATCH) | (tasks.status == S.IN_MQ)
             ).sum(1).to(torch.float32)
    b = _bucket(mt.spec, depth)[:, None].long()
    mt.queue_depth.scatter_add_(1, b, act.to(torch.int32)[:, None])


def _window(spec: MetricsSpec, t_end: torch.Tensor) -> torch.Tensor:
    """SLO window of each terminal time.  The reference's compiler turns
    the division by the constant width into a multiplication by its
    float32 reciprocal, and its float-to-int conversion saturates and
    sends NaN to 0; both are reproduced here."""
    x = t_end * float(np.float32(1.0) / np.float32(spec.window_s))
    return torch.nan_to_num(x, nan=0.0).clamp(0, spec.windows - 1).to(
        torch.int32)


def fold_tasks(mt: SimMetrics, tasks: S.TaskTable,
               mask: torch.Tensor | None = None) -> SimMetrics:
    """Fold per-task telemetry of (a masked subset of) a task table
    whose selected rows are terminal with final times: response =
    t_end - arrival and slowdown = response / max(t_end - t_start, eps)
    of completions, wait = t_start - arrival of tasks that ever started,
    and the window counters by ``t_end``."""
    spec = mt.spec
    status = tasks.status
    sel = torch.ones_like(status, dtype=torch.bool) if mask is None \
        else mask
    done = sel & (status == S.COMPLETED)
    started = sel & S.is_terminal(status) & (tasks.t_start >= 0.0)
    missed = sel & ((status == S.MISSED_QUEUE)
                    | (status == S.MISSED_RUNNING))
    resp = tasks.t_end - tasks.arrival
    wait = tasks.t_start - tasks.arrival
    slow = resp / (tasks.t_end - tasks.t_start).clamp(min=float(_EPS))
    k = _window(spec, tasks.t_end)
    over = done & (resp > np.float32(spec.slo_target))
    return SimMetrics(
        spec,
        response=_add(mt.response, _bucket(spec, resp), done),
        wait=_add(mt.wait, _bucket(spec, wait), started),
        slowdown=_add(mt.slowdown, _bucket(spec, slow), done),
        queue_depth=mt.queue_depth,
        win_done=_add(mt.win_done, k, done),
        win_miss=_add(mt.win_miss, k, missed),
        win_over=_add(mt.win_over, k, over),
    )


def merge(a: SimMetrics, b: SimMetrics) -> SimMetrics:
    """Elementwise sum of two instrument states (same spec)."""
    if a.spec != b.spec:
        raise ValueError(f"cannot merge specs {a.spec} != {b.spec}")
    return SimMetrics(a.spec, *(getattr(a, k) + getattr(b, k)
                                for k in SimMetrics._FIELDS))


def quantiles(counts: torch.Tensor, spec: MetricsSpec,
              qs: Sequence[float] = (50.0, 95.0, 99.0)) -> torch.Tensor:
    """(R, len(qs)) device twin of :func:`hist_quantile` over (R, B+2)
    counts, in float32 as the reference's ``quantiles_jnp``; 0 for an
    all-zero histogram."""
    dev = counts.device
    counts = counts.to(torch.float32)
    total = counts.sum(1, keepdim=True)       # integers: exact in any order
    cdf = torch.cumsum(counts, 1)
    # q / 100 in float32 on the host: the card divides a tensor by a
    # number as a multiplication by its reciprocal, which rounds otherwise
    q = torch.as_tensor(np.asarray(qs, np.float32) / np.float32(100.0),
                        device=dev)
    targets = torch.maximum(q[None, :] * total,
                            torch.tensor(1e-12, dtype=torch.float32,
                                         device=dev))
    b = torch.searchsorted(cdf.contiguous(), targets.contiguous()).clamp(
        0, counts.shape[1] - 1)
    prev = torch.where(b > 0, cdf.gather(1, (b - 1).clamp(min=0)), 0.0)
    frac = ((targets - prev) / torch.clamp(counts.gather(1, b),
                                           min=float(_EPS))).clamp(0.0, 1.0)
    lows_np, highs_np = bucket_bounds(spec)
    lows = torch.as_tensor(lows_np, dtype=torch.float32, device=dev)[b]
    highs = torch.as_tensor(highs_np, dtype=torch.float32, device=dev)[b]
    # the reference's compiled sweep contracts this into one fused
    # multiply-add
    out = fma(frac, highs - lows, lows)
    return torch.where(total > 0, out, 0.0)


quantiles_jnp = quantiles


def tail_columns(mt: SimMetrics) -> dict:
    """(R,) p50/p95/p99 columns of every histogram, on the device; keys
    as :func:`summary`'s (the sweeps' tail columns)."""
    out = {}
    for key, col in (("response", "resp"), ("wait", "wait"),
                     ("slowdown", "slow"), ("queue_depth", "qdepth")):
        q = quantiles(getattr(mt, key), mt.spec)
        for j, p in enumerate(("p50", "p95", "p99")):
            out[f"{col}_{p}"] = q[:, j]
    return out


# ---------------------------------------------------------------------------
# Numpy twin and host-side summaries
# ---------------------------------------------------------------------------
def bucket_np(spec: MetricsSpec, x) -> np.ndarray:
    """Numpy twin of :func:`_bucket`: float32 first, so edges straddle
    as on the device."""
    return np.searchsorted(bucket_edges(spec),
                           np.asarray(x, np.float32), side="right")


def fold_tasks_np(spec: MetricsSpec, status, arrival, t_start, t_end,
                  queue_depth: np.ndarray | None = None
                  ) -> dict[str, np.ndarray]:
    """Numpy twin of :func:`fold_tasks` over one replica's final task
    table; returns the counts dict of :func:`to_numpy`, with
    ``queue_depth`` passed through (zeros when absent)."""
    status = np.asarray(status)
    arrival = np.asarray(arrival, np.float32)
    t_start = np.asarray(t_start, np.float32)
    t_end = np.asarray(t_end, np.float32)

    done = status == S.COMPLETED
    started = (status >= S.COMPLETED) & (t_start >= 0.0)
    missed = (status == S.MISSED_QUEUE) | (status == S.MISSED_RUNNING)

    resp = t_end - arrival
    wait = t_start - arrival
    slow = resp / np.maximum(t_end - t_start, _EPS)

    nbin = spec.buckets + 2

    def hist(x, m):
        return np.bincount(bucket_np(spec, x[m]),
                           minlength=nbin).astype(np.int64)

    k = np.clip((t_end / np.float32(spec.window_s)).astype(np.int32),
                0, spec.windows - 1)

    def win(m):
        return np.bincount(k[m], minlength=spec.windows).astype(np.int64)

    return {
        "response": hist(resp, done),
        "wait": hist(wait, started),
        "slowdown": hist(slow, done),
        "queue_depth": (np.zeros(nbin, np.int64) if queue_depth is None
                        else np.asarray(queue_depth, np.int64)),
        "win_done": win(done),
        "win_miss": win(missed),
        "win_over": win(done & (resp > np.float32(spec.slo_target))),
    }


def to_numpy(mt: SimMetrics, replica: int | None = None
             ) -> dict[str, np.ndarray]:
    """Counts dict (int64 numpy) in the :func:`fold_tasks_np` schema: of
    replica ``replica``, or with the replica axis where None."""
    out = {}
    for k in SimMetrics._FIELDS:
        x = getattr(mt, k)
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
        out[k] = (x if replica is None else x[replica]).astype(np.int64)
    return out


def percentile(samples, q: float) -> float:
    """Exact sample percentile (linear interpolation); 0.0 for an empty
    sample set."""
    samples = np.asarray(samples, np.float64).ravel()
    if samples.size == 0:
        return 0.0
    return float(np.percentile(samples, q))


def hist_quantile(counts, spec_or_edges, q: float) -> float:
    """q-th percentile from histogram counts, interpolated linearly
    within the bucket where the CDF crosses q (underflow over [0, lo),
    overflow collapsed to the top edge); 0.0 for an all-zero
    histogram."""
    if isinstance(spec_or_edges, MetricsSpec):
        edges = bucket_edges(spec_or_edges).astype(np.float64)
    else:
        edges = np.asarray(spec_or_edges, np.float64)
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    if total <= 0:
        return 0.0
    # a zero target must still land in the first non-empty bucket
    target = max(np.clip(q, 0.0, 100.0) / 100.0 * total, 1e-12)
    cdf = np.cumsum(counts)
    b = min(int(np.searchsorted(cdf, target, side="left")),
            counts.size - 1)
    prev = cdf[b - 1] if b > 0 else 0.0
    frac = 0.0 if counts[b] <= 0 else float(
        np.clip((target - prev) / counts[b], 0.0, 1.0))
    lows = np.concatenate([[0.0], edges])
    highs = np.concatenate([edges, [edges[-1]]])
    return float(lows[b] + frac * (highs[b] - lows[b]))


def hist_percentiles(counts, spec_or_edges,
                     qs: Sequence[float] = (50.0, 95.0, 99.0)
                     ) -> dict[str, float]:
    """{"p50": ..., "p95": ..., "p99": ...} from histogram counts."""
    return {f"p{q:g}": hist_quantile(counts, spec_or_edges, q)
            for q in qs}


def _counts(mt_or_counts, spec, replica):
    if isinstance(mt_or_counts, SimMetrics):
        return to_numpy(mt_or_counts, replica), mt_or_counts.spec
    return mt_or_counts, spec or DEFAULT_SPEC


def summary(mt_or_counts: SimMetrics | dict[str, Any],
            spec: MetricsSpec | None = None,
            replica: int = 0) -> dict[str, float]:
    """Flat report columns of one replica (``replica`` of a
    ``SimMetrics``, or a counts dict + spec): p50/p95/p99 per histogram
    plus the SLO miss and over-target rates."""
    counts, spec = _counts(mt_or_counts, spec, replica)
    edges = bucket_edges(spec)
    out: dict[str, float] = {}
    for key, col in (("response", "resp"), ("wait", "wait"),
                     ("slowdown", "slow"), ("queue_depth", "qdepth")):
        for q in (50.0, 95.0, 99.0):
            out[f"{col}_p{q:g}"] = round(
                hist_quantile(counts[key], edges, q), 4)
    done = counts["win_done"].sum()
    miss = counts["win_miss"].sum()
    over = counts["win_over"].sum()
    terminal = done + miss
    out["slo_miss_rate"] = round(float(miss / max(terminal, 1)), 4)
    out["slo_over_rate"] = round(float(over / max(done, 1)), 4)
    return out


def window_report(mt_or_counts: SimMetrics | dict[str, Any],
                  spec: MetricsSpec | None = None,
                  replica: int = 0) -> list[dict[str, float]]:
    """Per-SLO-window rows of one replica: [t0, t1) bounds,
    completions, misses, over-target count, miss rate in the window."""
    counts, spec = _counts(mt_or_counts, spec, replica)
    rows = []
    for i in range(spec.windows):
        done = int(counts["win_done"][i])
        miss = int(counts["win_miss"][i])
        rows.append({
            "t0": i * spec.window_s,
            "t1": (i + 1) * spec.window_s,
            "done": done,
            "miss": miss,
            "over": int(counts["win_over"][i]),
            "miss_rate": round(miss / max(done + miss, 1), 4),
        })
    return rows
