"""Chunked Monte-Carlo sweeps: bounded device memory, an exact aggregate.

The counterpart of ``repro.launch.chunked``.  ``run_experiment(spec,
chunk=C)`` runs the grid C replicas at a time:

  chunk     each chunk is drawn on the host by
            :func:`experiment.normalize_chunk` (per-replica substreams
            make the grid random-access, so a chunk's draws are bitwise
            those of the whole grid), staged in pinned host memory and
            copied to the card on a side stream;
  reduce    each chunk's (C,) summary columns fold on the device into a
            per-column, per-policy accumulator: count, min, max, a
            log-bucket histogram on ``core/metrics.py`` edges and an
            **exact** sum.  Per-replica results reach the host only with
            ``keep_replicas=True``;
  overlap   one worker thread draws chunk c + 1 while the main thread
            drives chunk c through the engine (the engine's event loop
            runs on the host, so the draws of the next chunk must run
            beside it, not after it); the compute stream waits on the
            copy's event before it reads the chunk.  ``core/telemetry.py``
            spans record the timeline.

Every reference to a chunk's inputs, state and summaries is dropped once
the chunk is folded, so the caching allocator reuses its memory for the
next chunk and live device memory stays O(chunk).  Besides the engine's
own host reads, the chunk loop waits for the host once a chunk, at
retirement (the chunk's completion event, which also covers the host
copy of its summaries with ``keep_replicas``), and once at the end
(:meth:`SweepAgg.from_device`); the fold reads nothing back.

Exact summation, as in the reference: each float32 sample is split into
its signed 25-bit mantissa and biased exponent (a bit view, no
rounding), and the mantissa's high (``mant >> 12``) and low (``mant &
0xfff``) pieces are summed as integers per (policy, exponent) bin.
Integer addition is associative, so any order or partition of the
replicas gives the same accumulator; ``SweepAgg.total`` rounds the
exact sum once.  The reference emulates its 64-bit bins as (int32,
uint32) pairs; here they are int64 and hold the same integers.
"""
from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine as E
from repro_torch.core import metrics as ME
from repro_torch.core import schedulers as P
from repro_torch.core import state as S
from repro_torch.core import telemetry as TL
from repro_torch.launch import experiment as X

__all__ = [
    "SWEEP_SPEC", "MAX_CHUNK", "ColumnAgg", "SweepAgg", "ChunkedStats",
    "aggregate_metrics", "run_chunked_experiment",
]

#: log-bucket geometry of the per-column histograms (wide, because
#: report columns span counts, seconds and joules)
SWEEP_SPEC = ME.MetricsSpec(buckets=64, lo=1e-4, hi=1e7)

#: the reference's largest chunk (its 12-bit pieces sum in int32); kept
#: so that both packages accept the same calls
MAX_CHUNK = 1 << 18

_NAN_BELOW = -(1 << 33)   # min keys of NaNs: below every number's key
_NAN_ABOVE = 1 << 32      # max keys of NaNs: above every number's key


# ---------------------------------------------------------------------------
# The device accumulator
# ---------------------------------------------------------------------------
class ColumnAgg(NamedTuple):
    """Device accumulator of ONE summary column (leading policy axis P).
    ``a``/``b``: per biased-exponent bin, the sums of the mantissas'
    high (``mant >> 12``) and low (``mant & 0xfff``) pieces."""
    a: torch.Tensor      # i64 (P, 256)
    b: torch.Tensor      # i64 (P, 256)
    count: torch.Tensor  # i64 (P,)
    vmin: torch.Tensor   # f32 (P,)
    vmax: torch.Tensor   # f32 (P,)
    hist: torch.Tensor   # i64 (P, B + 2), SWEEP_SPEC log buckets


def _init_column(n_policy: int, aspec: ME.MetricsSpec,
                 device) -> ColumnAgg:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=device)

    def full(value):
        return torch.full((n_policy,), value, dtype=torch.float32,
                          device=device)

    return ColumnAgg(zeros(n_policy, 256), zeros(n_policy, 256),
                     zeros(n_policy), full(math.inf), full(-math.inf),
                     zeros(n_policy, aspec.buckets + 2))


def _decompose(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (signed 25-bit mantissa, exponent bin in [1, 255]),
    both int32: ``value == mant * 2**(bin - 150)`` exactly; normals carry
    the hidden bit, subnormals share bin 1's scale, ±inf land in bin
    255."""
    u = x.to(torch.float32).contiguous().view(torch.int32)
    bexp = (u >> 23) & 0xFF
    frac = u & 0x7FFFFF
    mant = torch.where(bexp > 0, frac | (1 << 23), frac)
    mant = torch.where(u < 0, -mant, mant)
    return mant, torch.clamp(bexp, min=1)


def _key(x: torch.Tensor, nan_base: int) -> torch.Tensor:
    """int64 keys that order float32 as the reference's scatter min and
    max do on the CPU: subnormals flushed to zeros of their sign, -0.0
    below +0.0, and every NaN wins (``nan_base`` plus its bits, so the
    NaN itself comes back)."""
    bits = x.contiguous().view(torch.int32)
    bits = torch.where((bits & 0x7F800000) == 0, bits & -(1 << 31),
                       bits).to(torch.int64)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.where(torch.isnan(x), nan_base + (bits & 0xFFFFFFFF), key)


def _unkey(k: torch.Tensor) -> torch.Tensor:
    """The float32 values of :func:`_key` keys."""
    nan = (k < -(1 << 31)) | (k >= (1 << 31))
    bits = torch.where(nan, k & 0xFFFFFFFF,
                       torch.where(k < 0, k ^ 0x7FFFFFFF, k))
    bits = torch.where(bits >= (1 << 31), bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def _fold_column(col: ColumnAgg, x: torch.Tensor, pol_idx: torch.Tensor,
                 aspec: ME.MetricsSpec, edges: torch.Tensor) -> None:
    """In place: fold one chunk's (C,) samples ``x`` of policy positions
    ``pol_idx`` (i64) into ``col``."""
    xf = x.to(torch.float32)
    mant, ebin = _decompose(xf)
    cell = pol_idx * 256 + ebin.to(torch.int64)
    col.a.view(-1).index_add_(0, cell, (mant >> 12).to(torch.int64))
    col.b.view(-1).index_add_(0, cell, (mant & 0xFFF).to(torch.int64))
    ones = torch.ones_like(pol_idx)
    col.count.index_add_(0, pol_idx, ones)
    lo = _key(col.vmin, _NAN_BELOW).scatter_reduce_(
        0, pol_idx, _key(xf, _NAN_BELOW), "amin")
    hi = _key(col.vmax, _NAN_ABOVE).scatter_reduce_(
        0, pol_idx, _key(xf, _NAN_ABOVE), "amax")
    col.vmin.copy_(_unkey(lo))
    col.vmax.copy_(_unkey(hi))
    width = aspec.buckets + 2
    col.hist.view(-1).index_add_(
        0, pol_idx * width + ME._bucket(aspec, xf, edges).to(torch.int64),
        ones)


def _fold(cols: dict, metrics: dict, pol_idx: torch.Tensor,
          aspec: ME.MetricsSpec, edges: torch.Tensor) -> None:
    for k, col in cols.items():
        _fold_column(col, metrics[k], pol_idx, aspec, edges)


def _to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev`` without waiting for the host: a host tensor goes
    to the card through pinned memory, asynchronously on the current
    stream."""
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``; from the card, into pinned memory on the
    current stream, complete once the stream passes this point."""
    if t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


def _edges(aspec: ME.MetricsSpec, dev: torch.device) -> torch.Tensor:
    return _to_device(torch.from_numpy(ME.bucket_edges(aspec)), dev)


# ---------------------------------------------------------------------------
# Host-side finalized aggregate
# ---------------------------------------------------------------------------
def _exact_total(a_row: np.ndarray, b_row: np.ndarray) -> float:
    """Σ_bin (a·2^12 + b)·2^(bin-150) in Python big-ints, rounded once."""
    n = 0
    for i in np.nonzero(a_row | b_row)[0]:
        n += ((int(a_row[i]) << 12) + int(b_row[i])) << int(i)
    return math.ldexp(float(n), -150) if n else 0.0


@dataclass
class SweepAgg:
    """Finalized (host) sweep aggregate: exact per-policy column stats.

    ``a``/``b`` are the exact int64 mantissa-piece sums per exponent
    bin; two aggregates over the same replicas are bitwise equal however
    the replicas were chunked or ordered.  ``quantile`` reconstructs
    tails from the log-bucket histogram through
    :func:`repro_torch.core.metrics.hist_quantile`.
    """
    policies: tuple[str, ...]
    spec: ME.MetricsSpec
    a: dict[str, np.ndarray]        # (P, 256) int64
    b: dict[str, np.ndarray]        # (P, 256) int64
    counts: np.ndarray              # (P,) int64
    vmin: dict[str, np.ndarray]     # (P,) float32
    vmax: dict[str, np.ndarray]     # (P,) float32
    hist: dict[str, np.ndarray]     # (P, B+2) int64

    @classmethod
    def from_device(cls, cols: dict, policies: tuple[str, ...],
                    aspec: ME.MetricsSpec) -> "SweepAgg":
        """The aggregate of the device accumulators ``cols``, in one host
        read (the float extremes travel as their int32 bits)."""
        parts = []
        for c in cols.values():
            parts += [c.a.flatten(), c.b.flatten(), c.count,
                      c.hist.flatten(),
                      c.vmin.view(torch.int32).to(torch.int64),
                      c.vmax.view(torch.int32).to(torch.int64)]
        flat = torch.cat(parts).cpu().numpy()
        n_p, width = len(policies), aspec.buckets + 2
        out = {f: {} for f in ("a", "b", "vmin", "vmax", "hist")}
        counts, at = None, 0

        def take(n):
            nonlocal at
            at += n
            return flat[at - n:at]

        for k in cols:
            out["a"][k] = take(256 * n_p).reshape(n_p, 256)
            out["b"][k] = take(256 * n_p).reshape(n_p, 256)
            counts = take(n_p)
            out["hist"][k] = take(width * n_p).reshape(n_p, width)
            for f in ("vmin", "vmax"):
                out[f][k] = take(n_p).astype(np.int32).view(np.float32)
        return cls(policies=tuple(policies), spec=aspec, counts=counts,
                   **out)

    # -- accessors --------------------------------------------------------
    @property
    def columns(self) -> tuple[str, ...]:
        return tuple(self.a)

    def _p(self, policy: str | None) -> int | None:
        return None if policy is None else self.policies.index(policy)

    def count(self, policy: str | None = None) -> int:
        p = self._p(policy)
        return int(self.counts.sum() if p is None else self.counts[p])

    def total(self, col: str, policy: str | None = None) -> float:
        """Exact sum of the column (correctly rounded to float)."""
        p = self._p(policy)
        a, b = self.a[col], self.b[col]
        if p is None:
            a, b = a.sum(axis=0), b.sum(axis=0)
        else:
            a, b = a[p], b[p]
        return _exact_total(a, b)

    def mean(self, col: str, policy: str | None = None) -> float:
        n = self.count(policy)
        return self.total(col, policy) / n if n else 0.0

    def min(self, col: str, policy: str | None = None) -> float:
        p = self._p(policy)
        v = self.vmin[col]
        return float(v.min() if p is None else v[p])

    def max(self, col: str, policy: str | None = None) -> float:
        p = self._p(policy)
        v = self.vmax[col]
        return float(v.max() if p is None else v[p])

    def quantile(self, col: str, q: float,
                 policy: str | None = None) -> float:
        p = self._p(policy)
        h = self.hist[col]
        h = h.sum(axis=0) if p is None else h[p]
        return ME.hist_quantile(h, self.spec, q)

    def column(self, col: str, policy: str | None = None) -> dict:
        return {"count": self.count(policy),
                "mean": self.mean(col, policy),
                "min": self.min(col, policy),
                "max": self.max(col, policy),
                "p50": self.quantile(col, 50.0, policy),
                "p95": self.quantile(col, 95.0, policy),
                "p99": self.quantile(col, 99.0, policy)}

    def summary(self, policy: str | None = None) -> dict:
        """{column: {count, mean, min, max, p50, p95, p99}} off the
        aggregate."""
        return {k: self.column(k, policy) for k in self.columns}

    def by_policy(self, keys: tuple[str, ...]) -> list[dict]:
        """Per-policy mean rows, shaped like
        :meth:`experiment.ExperimentResult.by_policy` (exact means)."""
        return [dict({"policy": pol, "replicas": self.count(pol)},
                     **{k: self.mean(k, pol) for k in keys})
                for pol in self.policies]

    def merge(self, other: "SweepAgg") -> "SweepAgg":
        """Exact fold of two disjoint aggregates (host side)."""
        if (self.policies != other.policies or self.spec != other.spec
                or self.columns != other.columns):
            raise ValueError("aggregates are not over the same grid shape")
        return SweepAgg(
            policies=self.policies, spec=self.spec,
            a={k: self.a[k] + other.a[k] for k in self.a},
            b={k: self.b[k] + other.b[k] for k in self.b},
            counts=self.counts + other.counts,
            vmin={k: np.minimum(self.vmin[k], other.vmin[k])
                  for k in self.vmin},
            vmax={k: np.maximum(self.vmax[k], other.vmax[k])
                  for k in self.vmax},
            hist={k: self.hist[k] + other.hist[k] for k in self.hist})


def _policy_index(policies: tuple[str, ...], policy_ids) -> np.ndarray:
    """Map replica policy ids -> position in the spec's policy tuple."""
    lut = np.full(max(P.POLICY_IDS.values()) + 1, -1, np.int64)
    for i, pol in enumerate(policies):
        lut[P.POLICY_IDS[pol]] = i
    idx = lut[np.asarray(policy_ids)]
    if (idx < 0).any():
        raise ValueError("replicas carry policy ids outside the spec's "
                         "policy axis")
    return idx


def aggregate_metrics(metrics: dict, policy_ids,
                      policies: tuple[str, ...],
                      aspec: ME.MetricsSpec = SWEEP_SPEC) -> SweepAgg:
    """Fold an already-materialized per-replica metrics dict (tensors on
    one device, e.g. a monolithic ``run_experiment``'s) on that device
    into a :class:`SweepAgg`; ``policy_ids`` is a tensor or an array."""
    if isinstance(policy_ids, torch.Tensor):
        policy_ids = policy_ids.cpu().numpy()
    pol_idx = _policy_index(tuple(policies), policy_ids)
    if pol_idx.shape[0] > MAX_CHUNK:
        raise ValueError(f"aggregate_metrics folds at most {MAX_CHUNK} "
                         f"replicas at once; got {pol_idx.shape[0]}")
    dev = next(iter(metrics.values())).device
    cols = {k: _init_column(len(policies), aspec, dev)
            for k in sorted(metrics)}
    _fold(cols, metrics, _to_device(torch.from_numpy(pol_idx), dev), aspec,
          _edges(aspec, dev))
    return SweepAgg.from_device(cols, tuple(policies), aspec)


# ---------------------------------------------------------------------------
# The overlapped chunk loop
# ---------------------------------------------------------------------------
@dataclass
class ChunkedStats:
    """Timing of a chunked run: where its wall-clock went.

    ``dispatch_s`` is the main thread's time driving chunks through the
    engine and folding them; ``sync_s`` its waits for chunks to
    complete; ``normalize_s`` the time drawing and staging chunks, of
    which ``overlap_s`` ran while the main thread drove a chunk;
    ``overlap_frac`` is ``overlap_s`` over the whole run."""
    chunk: int
    n_chunks: int
    normalize_s: float = 0.0
    dispatch_s: float = 0.0
    sync_s: float = 0.0
    overlap_s: float = 0.0
    wall_s: float = 0.0

    @property
    def overlap_frac(self) -> float:
        return self.overlap_s / self.wall_s if self.wall_s else 0.0


class _Staged(NamedTuple):
    """One chunk's inputs on the device, usable once ``ready`` is
    passed (None on the CPU)."""
    reps: X.Replicas
    pol_idx: torch.Tensor
    ready: torch.cuda.Event | None


def run_chunked_experiment(spec: X.ExperimentSpec, chunk: int, *,
                           device="cuda",
                           replicas: X.Replicas | None = None,
                           keep_replicas: bool = False,
                           on_chunk: Callable[[int], None] | None = None,
                           aspec: ME.MetricsSpec = SWEEP_SPEC,
                           stats: E.RunStats | None = None,
                           policy_params=None) -> X.ExperimentResult:
    """The chunked twin of ``run_experiment``, normally reached as
    ``run_experiment(spec, chunk=...)``.

    Per chunk c: a worker thread draws and stages chunk c + 1 while the
    main thread drives chunk c through the engine and folds it; chunk c
    - 2 retires (its completion event) before chunk c runs, so at most
    two chunks are in flight.  ``replicas`` (on ``device``) replaces the
    draws with slices of the caller's grid; ``on_chunk(c)`` fires as
    chunk c retires; ``stats`` sums the engine's counters over the
    chunks; ``policy_params``, shared by every replica, are the learned
    policies' weights.  Returns an ``experiment.ExperimentResult`` whose
    ``agg`` is the :class:`SweepAgg` and ``chunked`` the
    :class:`ChunkedStats`;
    ``metrics`` holds the per-replica columns on the host only with
    ``keep_replicas=True``."""
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk must be <= {MAX_CHUNK} (exact-sum "
                         f"scatter bound), got {chunk}")
    if spec.sim_params.trace:
        raise ValueError("trace=True is O(R) host memory — incompatible "
                         "with chunked execution")
    n_rep = spec.n_replicas
    if replicas is not None and replicas.n_replicas != n_rep:
        raise ValueError(f"replicas carry {replicas.n_replicas} rows, "
                         f"spec asks for {n_rep}")
    dev = resolve_device(device)
    if policy_params is not None:
        # once, before the loop: a copy inside it would wait for the host
        policy_params = policy_params.to(dev)
    n_chunks = -(-n_rep // chunk)
    policies = spec.policy.policies
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    given_idx = None if replicas is None else _policy_index(
        policies, replicas.policy_ids.cpu().numpy())

    def stage(lo: int, hi: int) -> _Staged:
        """Chunk [lo, hi) drawn on the host (or sliced from
        ``replicas``) and copied to the card on the side stream."""
        if replicas is None:
            host = X.normalize_chunk(spec, lo, hi, device="cpu")
            idx = _policy_index(policies, host.policy_ids.numpy())
        else:
            host = S._map(replicas, lambda x: x[lo:hi])
            idx = given_idx[lo:hi]
        idx = torch.from_numpy(idx)
        if copy_stream is None:
            return _Staged(host, idx, None)
        with torch.cuda.stream(copy_stream):
            reps = S._map(host, lambda x: _to_device(x, dev))
            idx = _to_device(idx, dev)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return _Staged(reps, idx, ready)

    def stage_overlapped(c: int, lo: int, hi: int, parent: str | None):
        with TL.adopted(parent) as held:
            t0 = time.perf_counter()
            with TL.span("chunk_normalize", chunk=c, overlapped=True):
                staged = stage(lo, hi)
            t1 = time.perf_counter()
        return staged, t0, t1, held

    cols: dict = {}
    edges = _edges(aspec, dev)

    def dispatch(staged: _Staged):
        """Run one chunk and fold it; returns its completion event and
        its host columns (with ``keep_replicas``)."""
        reps, pol_idx = staged.reps, staged.pol_idx
        if staged.ready is not None:
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(staged.ready)

            def used_here(t):
                t.record_stream(compute)
                return t
            reps, pol_idx = S._map(reps, used_here), used_here(pol_idx)
        metrics = X._execute(spec, reps, stats, policy_params).metrics
        if not cols:
            cols.update({k: _init_column(len(policies), aspec, dev)
                         for k in sorted(metrics)})
        _fold(cols, metrics, pol_idx, aspec, edges)
        host = ({k: _to_host(v) for k, v in metrics.items()}
                if keep_replicas else None)
        done = None
        if copy_stream is not None:
            done = torch.cuda.Event()
            done.record()
        return done, host

    cstats = ChunkedStats(chunk=chunk, n_chunks=n_chunks)
    kept: list[dict] = []
    pending: list = []   # [(chunk, completion event, host columns)]

    def retire():
        c, done, host = pending.pop(0)
        t0 = time.perf_counter()
        with TL.span("chunk_sync", chunk=c):
            if done is not None:
                done.synchronize()
        cstats.sync_s += time.perf_counter() - t0
        if host is not None:
            kept.append(host)
        if on_chunk is not None:
            on_chunk(c)

    t_wall = time.perf_counter()
    with TL.span("experiment", chunked=True, chunk=chunk,
                 n_chunks=n_chunks, n_replicas=n_rep,
                 streaming=spec.streaming, policies=policies,
                 backend=dev.type) as xsp, \
            ThreadPoolExecutor(1, thread_name_prefix="normalize") as pool:
        t0 = time.perf_counter()
        with TL.span("chunk_normalize", chunk=0, overlapped=False):
            cur = stage(0, min(chunk, n_rep))
        cstats.normalize_s += time.perf_counter() - t0
        for c in range(n_chunks):
            nxt = None
            if c + 1 < n_chunks:
                lo = (c + 1) * chunk
                nxt = pool.submit(stage_overlapped, c + 1, lo,
                                  min(lo + chunk, n_rep), TL.open_span())
            while len(pending) > 1:       # retire everything but c - 1
                retire()
            d0 = time.perf_counter()
            with TL.span("chunk_dispatch", chunk=c):
                pending.append((c, *dispatch(cur)))
            d1 = time.perf_counter()
            cur = None                    # the chunk's inputs can go
            cstats.dispatch_s += d1 - d0
            if nxt is not None:
                cur, w0, w1, held = nxt.result()
                TL.write_held(held)
                cstats.normalize_s += w1 - w0
                cstats.overlap_s += max(0.0, min(w1, d1) - max(w0, d0))
        while pending:
            retire()
        agg = SweepAgg.from_device(cols, policies, aspec)
        cstats.wall_s = time.perf_counter() - t_wall
        xsp.update(normalize_s=round(cstats.normalize_s, 6),
                   dispatch_s=round(cstats.dispatch_s, 6),
                   sync_s=round(cstats.sync_s, 6),
                   overlap_s=round(cstats.overlap_s, 6),
                   overlap_frac=round(cstats.overlap_frac, 6))
    metrics = None
    if keep_replicas:
        metrics = {k: torch.cat([m[k] for m in kept]) for k in kept[0]}
    return X.ExperimentResult(spec=spec, replicas=None, metrics=metrics,
                              agg=agg, chunked=cstats)
