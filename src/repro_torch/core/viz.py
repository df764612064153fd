"""Headless visual reporting from simulation traces (paper feature (iv)).

The counterpart of ``repro.core.viz``, an own copy of its numpy-only
renderers over the port's ``trace`` and ``metrics``: the same SVG and
HTML strings for the same trace.  The E2C GUI's value is *seeing* a
schedule: the Gantt panel, the queue views, the energy gauge.  This
module reconstructs those views from a ``trace.TraceBuffer``
(``simulate(..., trace=True)``, ``ExperimentSpec(trace=True)``) and
renders them as standalone SVG / HTML with numpy only.  The port's
buffers carry a leading replica axis: each chart of a state or buffer
draws replica ``replica`` (default 0), and ``replica_trace`` cuts one
out as numpy arrays.

Charts (each returns an SVG string; ``save`` writes it):

* ``gantt``        per-machine execution segments, colored by outcome;
                   a preempted-and-requeued task shows as a split bar,
                   down intervals as shaded spans.  Workflow mode draws
                   one arrow per dependency edge and overlays the
                   realized critical path (docs/workflows.md).
* ``utilization``  fleet busy-fraction over time (step curve).
* ``queue_depth``  batch-queue depth + total machine-queue depth.
* ``energy_over_time``  cumulative active energy.
* ``html_report``  all four in one standalone HTML page.
* ``sweep_utilization``  mean busy-fraction across the replicas of a
                   vmapped traced sweep (faint per-replica curves).
* ``metrics_dashboard``  the telemetry view (docs/observability.md):
                   latency/wait/slowdown/queue-depth histograms with
                   p50/p95/p99 annotations plus the per-window SLO
                   panel, from a ``simulate(..., metrics=True)`` run.

Outcome colors use a status palette (completed=green, requeued=amber,
killed=orange-red, missed=red); every chart carries a text legend so
color never carries meaning alone.
"""
from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np

from repro_torch.core import metrics as ME
from repro_torch.core import trace as T

# --- chart chrome (light-surface palette, the reference's) ---------------
SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK_2 = "#52514e"
MUTED = "#898781"
GRID = "#e1e0d9"
AXIS = "#c3c2b7"
SERIES_1 = "#2a78d6"   # blue
SERIES_2 = "#eb6834"   # orange
SERIES_3 = "#1d9a8f"   # teal
DOWN_FILL = "#e1e0d9"  # machine-down shading

OUTCOME_COLORS = {
    T.EV_COMPLETE: "#0ca30c",      # good
    T.EV_REQUEUE: "#fab219",       # warning: evicted, ran again later
    T.EV_PREEMPT: "#ec835a",       # serious: killed by spot reclaim
    T.EV_MISS_RUNNING: "#d03b3b",  # critical: deadline hit mid-run
    None: "#898781",               # still open when the trace ended
}
OUTCOME_LABELS = {
    T.EV_COMPLETE: "completed",
    T.EV_REQUEUE: "requeued",
    T.EV_PREEMPT: "killed",
    T.EV_MISS_RUNNING: "missed",
    None: "open",
}

FONT = ('font-family="system-ui, -apple-system, \'Segoe UI\', sans-serif"')


_resolve = T.resolve        # SimState-or-TraceBuffer -> (buffer, n_events)
_np = T._np                 # a tensor or array as numpy


def _esc(s: str) -> str:
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def _ticks(lo: float, hi: float, n: int = 6) -> np.ndarray:
    if hi <= lo:
        hi = lo + 1.0
    raw = (hi - lo) / max(n, 1)
    mag = 10.0 ** np.floor(np.log10(raw))
    step = min((m for m in (1, 2, 2.5, 5, 10)
                if m * mag >= raw), default=10) * mag
    t0 = np.ceil(lo / step) * step
    return np.arange(t0, hi + step * 1e-9, step)


def _fmt(v: float) -> str:
    return f"{v:g}" if abs(v) < 1e4 else f"{v:.2e}"


class _Frame:
    """Minimal SVG line-chart scaffold: surface, grid, axes, labels."""

    def __init__(self, width: int, height: int, x_range, y_range,
                 title: str, xlabel: str = "time (s)", ylabel: str = "",
                 pad_l: int = 52, pad_r: int = 16, pad_t: int = 34,
                 pad_b: int = 36, y_axis: bool = True, x_axis: bool = True):
        self.w, self.h = width, height
        self.x0, self.x1 = float(x_range[0]), float(max(*x_range, x_range[0] + 1e-9))
        self.y0, self.y1 = float(y_range[0]), float(y_range[1])
        if self.y1 <= self.y0:
            self.y1 = self.y0 + 1.0
        self.pl, self.pr, self.pt, self.pb = pad_l, pad_r, pad_t, pad_b
        self.parts: list[str] = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{height}" viewBox="0 0 {width} {height}" '
            f'role="img" aria-label="{_esc(title)}">',
            f'<rect width="{width}" height="{height}" fill="{SURFACE}"/>',
            f'<text x="{pad_l}" y="20" {FONT} font-size="13" '
            f'font-weight="600" fill="{INK}">{_esc(title)}</text>',
        ]
        self._axes(xlabel, ylabel, y_axis, x_axis)

    def sx(self, x) -> np.ndarray:
        x = np.asarray(x, float)
        return self.pl + (x - self.x0) / (self.x1 - self.x0) \
            * (self.w - self.pl - self.pr)

    def sy(self, y) -> np.ndarray:
        y = np.asarray(y, float)
        return self.h - self.pb - (y - self.y0) / (self.y1 - self.y0) \
            * (self.h - self.pt - self.pb)

    def _axes(self, xlabel: str, ylabel: str, y_axis: bool = True,
              x_axis: bool = True):
        bot, left = self.h - self.pb, self.pl
        for tx in (_ticks(self.x0, self.x1) if x_axis else ()):
            px = float(self.sx(tx))
            self.parts.append(
                f'<line x1="{px:.1f}" y1="{self.pt}" x2="{px:.1f}" '
                f'y2="{bot}" stroke="{GRID}" stroke-width="1"/>')
            self.parts.append(
                f'<text x="{px:.1f}" y="{bot + 14}" {FONT} font-size="10" '
                f'fill="{MUTED}" text-anchor="middle">{_fmt(tx)}</text>')
        for ty in (_ticks(self.y0, self.y1, 4) if y_axis else ()):
            py = float(self.sy(ty))
            self.parts.append(
                f'<line x1="{left}" y1="{py:.1f}" x2="{self.w - self.pr}" '
                f'y2="{py:.1f}" stroke="{GRID}" stroke-width="1"/>')
            self.parts.append(
                f'<text x="{left - 6}" y="{py + 3:.1f}" {FONT} '
                f'font-size="10" fill="{MUTED}" '
                f'text-anchor="end">{_fmt(ty)}</text>')
        self.parts.append(
            f'<line x1="{left}" y1="{bot}" x2="{self.w - self.pr}" '
            f'y2="{bot}" stroke="{AXIS}" stroke-width="1"/>')
        if xlabel:
            self.parts.append(
                f'<text x="{(left + self.w - self.pr) / 2:.0f}" '
                f'y="{self.h - 8}" {FONT} font-size="10" fill="{INK_2}" '
                f'text-anchor="middle">{_esc(xlabel)}</text>')
        if ylabel:
            self.parts.append(
                f'<text x="14" y="{(self.pt + bot) / 2:.0f}" {FONT} '
                f'font-size="10" fill="{INK_2}" text-anchor="middle" '
                f'transform="rotate(-90 14 {(self.pt + bot) / 2:.0f})">'
                f'{_esc(ylabel)}</text>')

    def step_path(self, x: np.ndarray, y: np.ndarray, color: str,
                  width: float = 2.0, opacity: float = 1.0,
                  fill: str | None = None):
        """Piecewise-constant curve: hold y[i] until x[i+1]."""
        if x.size == 0:
            return
        px, py = self.sx(x), self.sy(y)
        d = [f"M{px[0]:.1f},{py[0]:.1f}"]
        for i in range(1, x.size):
            d.append(f"H{px[i]:.1f}")
            d.append(f"V{py[i]:.1f}")
        d.append(f"H{self.sx(self.x1):.1f}")
        path = " ".join(d)
        if fill:
            base = self.sy(self.y0)
            self.parts.append(
                f'<path d="{path} V{base:.1f} H{px[0]:.1f} Z" '
                f'fill="{fill}" fill-opacity="0.12" stroke="none"/>')
        self.parts.append(
            f'<path d="{path}" fill="none" stroke="{color}" '
            f'stroke-width="{width}" stroke-opacity="{opacity}" '
            f'stroke-linejoin="round"/>')

    def legend(self, entries: Sequence[tuple[str, str]]):
        """Swatch + text label pairs, top-right."""
        x = self.w - self.pr
        for label, color in reversed(list(entries)):
            est = 10 + 6.2 * len(label)
            x -= est + 14
            self.parts.append(
                f'<rect x="{x:.0f}" y="12" width="10" height="10" rx="2" '
                f'fill="{color}"/>')
            self.parts.append(
                f'<text x="{x + 14:.0f}" y="21" {FONT} font-size="10" '
                f'fill="{INK_2}">{_esc(label)}</text>')

    def render(self) -> str:
        return "\n".join(self.parts) + "\n</svg>"


def _span(tb: T.TraceBuffer, n_events: int | None) -> float:
    snaps = T.snapshots(tb, n_events)
    ev = T.events(tb)
    hi = 0.0
    if snaps["time"].size:
        hi = max(hi, float(snaps["time"][-1]))
    if ev["time"].size:
        hi = max(hi, float(ev["time"][-1]))
    return hi


# --------------------------------------------------------------------------
# Gantt
# --------------------------------------------------------------------------
def gantt(trace_or_state, dynamics=None, width: int = 960,
          row_h: int = 22, title: str = "Schedule (Gantt)",
          workflow=None, critical_path: bool = True,
          replica: int = 0) -> str:
    """Per-machine execution timeline, one bar per execution segment.

    Segment color encodes the outcome (see legend); a task evicted by a
    failure and restarted elsewhere appears as a split bar — the amber
    "requeued" slice is the work that was lost.  Pass the scenario
    ``dynamics`` (``state.MachineDynamics`` or ``workload.Scenario``) to
    shade each machine's down intervals (a batched one is read at
    ``replica``).

    Pass ``workflow`` (a ``workload.Workflow`` or a raw ``(N, K)``
    parent table) to draw the DAG: one arrow per dependency edge, from
    the parent's last execution segment to the child's first.  With
    ``critical_path=True`` the realized critical path — the chain of
    dependencies ending at the last task to finish, following the
    latest-finishing parent at each hop — is overlaid: its bars are
    outlined and its arrows drawn bold (docs/workflows.md).
    """
    tb, n_events = _resolve(trace_or_state, replica)
    segs = T.segments(tb)
    n_m = tb.snap_mq.shape[-1]
    span = max(_span(tb, n_events), 1e-9)
    pad_l, pad_r, pad_t, pad_b = 52, 16, 40, 36
    height = pad_t + pad_b + row_h * n_m
    # machine lanes replace the y axis (y_axis=False: no y grid/ticks)
    fr = _Frame(width, height, (0.0, span), (0.0, 1.0), title,
                xlabel="time (s)", pad_l=pad_l, pad_r=pad_r, pad_t=pad_t,
                pad_b=pad_b, y_axis=False)

    def lane_y(m: int) -> float:
        return pad_t + m * row_h

    for m in range(n_m):
        fr.parts.append(f'<text x="{pad_l - 6}" y="{lane_y(m) + row_h / 2 + 3:.0f}" '
                        f'{FONT} font-size="10" fill="{MUTED}" '
                        f'text-anchor="end">m{m:02d}</text>')

    # down-interval shading (behind segments)
    dyn = dynamics          # a MachineDynamics or a workload.Scenario
    if dyn is not None:
        ds = _np(dyn.down_start).astype(float)
        de = _np(dyn.down_end).astype(float)
        if ds.ndim == 3:                      # a leading replica axis
            ds, de = ds[replica], de[replica]
        for m in range(min(n_m, ds.shape[0])):
            for k in range(ds.shape[1]):
                a, b = ds[m, k], min(de[m, k], span)
                if not np.isfinite(a) or b <= a:
                    continue
                x0, x1 = float(fr.sx(a)), float(fr.sx(min(b, span)))
                fr.parts.append(
                    f'<rect x="{x0:.1f}" y="{lane_y(m) + 1:.1f}" '
                    f'width="{max(x1 - x0, 1):.1f}" height="{row_h - 2}" '
                    f'fill="{DOWN_FILL}" fill-opacity="0.8">'
                    f'<title>m{m} down {a:.2f}-{b:.2f}s</title></rect>')

    bar_h = row_h - 8
    for s in segs:
        x0, x1 = float(fr.sx(s["t0"])), float(fr.sx(s["t1"]))
        color = OUTCOME_COLORS[s["outcome"]]
        label = OUTCOME_LABELS[s["outcome"]]
        y = lane_y(s["machine"]) + (row_h - bar_h) / 2
        fr.parts.append(
            f'<rect x="{x0:.1f}" y="{y:.1f}" '
            f'width="{max(x1 - x0 - 0.5, 1.0):.1f}" height="{bar_h}" '
            f'rx="2" fill="{color}">'
            f'<title>task {s["task"]} on m{s["machine"]}: '
            f'{s["t0"]:.2f}-{s["t1"]:.2f}s ({label})</title></rect>')

    # dependency arrows + realized-critical-path overlay (workflow mode)
    parents = getattr(workflow, "parents", workflow)
    on_path: set[int] = set()
    if parents is not None:
        parents = _np(parents).astype(int)
        if parents.ndim == 3:                 # a leading replica axis
            parents = parents[replica]
        first_seg: dict[int, dict] = {}
        last_seg: dict[int, dict] = {}
        for s in segs:
            t = s["task"]
            if t not in first_seg or s["t0"] < first_seg[t]["t0"]:
                first_seg[t] = s
            if t not in last_seg or s["t1"] > last_seg[t]["t1"]:
                last_seg[t] = s
        if critical_path and last_seg:
            # walk back from the last task to finish, through the
            # latest-finishing parent at each hop
            t = max(last_seg, key=lambda k: (last_seg[k]["t1"], -k))
            chain = [t]
            while True:
                ps = [int(p) for p in parents[chain[-1]]
                      if p >= 0 and int(p) in last_seg]
                if not ps:
                    break
                chain.append(max(ps, key=lambda p: (last_seg[p]["t1"],
                                                    -p)))
            on_path = set(chain)
        fr.parts.append(
            '<defs><marker id="dep-arrow" viewBox="0 0 8 8" refX="7" '
            'refY="4" markerWidth="6" markerHeight="6" orient="auto">'
            f'<path d="M0,0 L8,4 L0,8 z" fill="{INK_2}"/></marker>'
            '<marker id="cp-arrow" viewBox="0 0 8 8" refX="7" refY="4" '
            'markerWidth="6" markerHeight="6" orient="auto">'
            f'<path d="M0,0 L8,4 L0,8 z" fill="{SERIES_2}"/></marker>'
            '</defs>')
        for c in range(parents.shape[0]):
            if c not in first_seg:
                continue
            cs = first_seg[c]
            for p in parents[c]:
                p = int(p)
                if p < 0 or p not in last_seg:
                    continue
                ps = last_seg[p]
                cp = (p in on_path) and (c in on_path)
                x0 = float(fr.sx(ps["t1"]))
                y0 = lane_y(ps["machine"]) + row_h / 2
                x1 = float(fr.sx(cs["t0"]))
                y1 = lane_y(cs["machine"]) + row_h / 2
                color = SERIES_2 if cp else INK_2
                w = 1.8 if cp else 1.0
                op = 0.95 if cp else 0.55
                marker = "cp-arrow" if cp else "dep-arrow"
                fr.parts.append(
                    f'<line x1="{x0:.1f}" y1="{y0:.1f}" x2="{x1:.1f}" '
                    f'y2="{y1:.1f}" stroke="{color}" stroke-width="{w}" '
                    f'stroke-opacity="{op}" '
                    f'marker-end="url(#{marker})">'
                    f'<title>task {p} &#8594; task {c}</title></line>')
        for t in on_path:          # outline the critical path's bars
            for s in (first_seg[t], last_seg[t]):
                x0, x1 = float(fr.sx(s["t0"])), float(fr.sx(s["t1"]))
                y = lane_y(s["machine"]) + (row_h - bar_h) / 2
                fr.parts.append(
                    f'<rect x="{x0:.1f}" y="{y:.1f}" '
                    f'width="{max(x1 - x0 - 0.5, 1.0):.1f}" '
                    f'height="{bar_h}" rx="2" fill="none" '
                    f'stroke="{SERIES_2}" stroke-width="1.6"/>')

    entries = [(OUTCOME_LABELS[k], OUTCOME_COLORS[k])
               for k in (T.EV_COMPLETE, T.EV_REQUEUE, T.EV_PREEMPT,
                         T.EV_MISS_RUNNING)]
    if dyn is not None:
        entries.append(("down", DOWN_FILL))
    if parents is not None and on_path:
        entries.append(("critical path", SERIES_2))
    fr.legend(entries)
    return fr.render()


# --------------------------------------------------------------------------
# Step-curve charts from the per-event snapshots
# --------------------------------------------------------------------------
def busy_fraction(trace_or_state, replica: int = 0
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(times, fraction-of-machines-busy) step samples, one per event."""
    tb, n_events = _resolve(trace_or_state, replica)
    snaps = T.snapshots(tb, n_events)
    n_m = max(tb.snap_mq.shape[-1], 1)
    busy = (snaps["running"] >= 0).sum(axis=-1) / n_m
    return snaps["time"], busy


def utilization(trace_or_state, width: int = 960, height: int = 220,
                title: str = "Fleet utilization", replica: int = 0) -> str:
    """Fraction of machines executing work, after each event."""
    t, busy = busy_fraction(trace_or_state, replica)
    tb, n_events = _resolve(trace_or_state, replica)
    fr = _Frame(width, height, (0.0, max(_span(tb, n_events), 1e-9)),
                (0.0, 1.0), title, ylabel="busy fraction")
    fr.step_path(t, busy, SERIES_1, fill=SERIES_1)
    return fr.render()


def queue_depth(trace_or_state, width: int = 960, height: int = 220,
                title: str = "Queue dynamics", replica: int = 0) -> str:
    """Batch-queue depth and total machine-queue depth over time."""
    tb, n_events = _resolve(trace_or_state, replica)
    snaps = T.snapshots(tb, n_events)
    t = snaps["time"]
    batch = snaps["batch"].astype(float)
    mq = snaps["mq"].sum(axis=-1).astype(float)
    top = max(float(batch.max(initial=0.0)), float(mq.max(initial=0.0)), 1.0)
    fr = _Frame(width, height, (0.0, max(_span(tb, n_events), 1e-9)),
                (0.0, top * 1.1), title, ylabel="tasks waiting")
    fr.step_path(t, batch, SERIES_1)
    fr.step_path(t, mq, SERIES_2)
    fr.legend([("batch queue", SERIES_1), ("machine queues", SERIES_2)])
    return fr.render()


def energy_over_time(trace_or_state, width: int = 960, height: int = 220,
                     title: str = "Cumulative active energy",
                     replica: int = 0) -> str:
    """Total active energy accrued by the fleet, after each event."""
    tb, n_events = _resolve(trace_or_state, replica)
    snaps = T.snapshots(tb, n_events)
    t = snaps["time"]
    e = snaps["energy"].sum(axis=-1)
    top = max(float(e.max(initial=0.0)), 1e-9)
    fr = _Frame(width, height, (0.0, max(_span(tb, n_events), 1e-9)),
                (0.0, top * 1.1), title, ylabel="energy (J)")
    fr.step_path(t, e, SERIES_1, fill=SERIES_1)
    return fr.render()


# --------------------------------------------------------------------------
# Sweep aggregation (vmapped traced replicas)
# --------------------------------------------------------------------------
def replica_trace(stacked: Any, i: int) -> T.TraceBuffer:
    """Replica ``i`` of a trace (or state) with a leading replica axis,
    as numpy arrays (``trace.replica_trace``)."""
    return T.replica_trace(stacked, i)


def sweep_busy_curves(traces, n_points: int = 128
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(grid, curves[R, n_points]) busy fractions on a common time grid.

    ``traces`` is a stacked TraceBuffer (leading replica axis) or a list
    of per-replica TraceBuffers.
    """
    if isinstance(traces, T.TraceBuffer):
        n_rows = _np(traces.n_rows)
        # leading axis => stacked sweep output; unstack every replica
        # (ndim == 0 means a single replica's buffers were passed)
        traces = [replica_trace(traces, i) for i in range(n_rows.shape[0])] \
            if n_rows.ndim else [traces]
    curves_t, curves_v, hi = [], [], 0.0
    for tb in traces:
        t, busy = busy_fraction(tb)
        curves_t.append(t)
        curves_v.append(busy)
        hi = max(hi, float(t[-1]) if t.size else 0.0)
    grid = np.linspace(0.0, max(hi, 1e-9), n_points)
    out = np.zeros((len(curves_t), n_points))
    for i, (t, v) in enumerate(zip(curves_t, curves_v)):
        if t.size == 0:
            continue
        idx = np.clip(np.searchsorted(t, grid, side="right") - 1, 0,
                      t.size - 1)
        out[i] = np.where(grid >= t[0], v[idx], 0.0)
    return grid, out


def sweep_utilization(traces, width: int = 960, height: int = 240,
                      n_points: int = 128,
                      title: str = "Mean fleet utilization across replicas"
                      ) -> str:
    """Aggregate utilization chart: faint per-replica step curves under
    the across-replica mean."""
    grid, curves = sweep_busy_curves(traces, n_points)
    fr = _Frame(width, height, (0.0, float(grid[-1])), (0.0, 1.0), title,
                ylabel="busy fraction")
    for row in curves[:64]:          # cap the spaghetti, keep the mean exact
        fr.step_path(grid, row, MUTED, width=1.0, opacity=0.25)
    fr.step_path(grid, curves.mean(axis=0), SERIES_1, width=2.5)
    fr.legend([("replica", MUTED), ("mean", SERIES_1)])
    return fr.render()


# --------------------------------------------------------------------------
# Telemetry dashboard (core/metrics.py instruments)
# --------------------------------------------------------------------------
def _hist_panel(counts, spec: ME.MetricsSpec, title: str, color: str,
                xlabel: str, width: int, height: int) -> str:
    """One histogram panel: bars per counts bin (uniform index spacing ==
    log-x, since buckets are log-spaced), tail percentiles in the title,
    exact bucket ranges in tooltips."""
    counts = np.asarray(counts, float)
    nbin = counts.size
    lows, highs = ME.bucket_bounds(spec)
    p = ME.hist_percentiles(counts, spec)
    top = max(float(counts.max(initial=0.0)), 1.0)
    fr = _Frame(width, height, (0.0, float(nbin)), (0.0, top * 1.1),
                f"{title}  p50={p['p50']:.3g} p95={p['p95']:.3g} "
                f"p99={p['p99']:.3g}",
                xlabel=xlabel, ylabel="count", x_axis=False)
    base = float(fr.sy(0.0))
    for i in range(nbin):
        c = counts[i]
        if c <= 0:
            continue
        x0, x1 = float(fr.sx(i)), float(fr.sx(i + 1))
        y = float(fr.sy(c))
        kind = ("underflow " if i == 0
                else "overflow " if i == nbin - 1 else "")
        fr.parts.append(
            f'<rect x="{x0 + 0.5:.1f}" y="{y:.1f}" '
            f'width="{max(x1 - x0 - 1.0, 1.0):.1f}" '
            f'height="{max(base - y, 0.5):.1f}" fill="{color}">'
            f'<title>{kind}[{lows[i]:.3g}, {highs[i]:.3g}): '
            f'{int(c)}</title></rect>')
    bot = fr.h - fr.pb
    for i in {1, nbin // 4, nbin // 2, 3 * nbin // 4, nbin - 1}:
        px = float(fr.sx(i))
        fr.parts.append(
            f'<text x="{px:.1f}" y="{bot + 14}" {FONT} font-size="10" '
            f'fill="{MUTED}" text-anchor="middle">{_fmt(lows[i])}</text>')
    return fr.render()


def _slo_window_panel(counts: dict, spec: ME.MetricsSpec, width: int,
                      height: int) -> str:
    """Grouped bars per SLO window: completions / deadline misses /
    over-target completions, so miss *bursts* are visible."""
    rows = ME.window_report(counts, spec)
    series = (("done", SERIES_1), ("miss", "#d03b3b"), ("over", SERIES_2))
    top = max(max(r[k] for r in rows for k, _ in series), 1)
    fr = _Frame(width, height, (0.0, 1.0), (0.0, top * 1.1),
                "SLO windows (completions / misses / over-target)",
                xlabel="", ylabel="count", pad_b=44, x_axis=False)
    plot_w = width - fr.pl - fr.pr
    group_w = plot_w / max(len(rows), 1)
    bar_w = min(22.0, 0.8 * group_w / len(series))
    base = float(fr.sy(0.0))
    for i, r in enumerate(rows):
        x_mid = fr.pl + (i + 0.5) * group_w
        x0 = x_mid - bar_w * len(series) / 2
        for j, (k, color) in enumerate(series):
            v = float(r[k])
            h = float(base - fr.sy(v))
            fr.parts.append(
                f'<rect x="{x0 + j * bar_w + 1:.1f}" y="{base - h:.1f}" '
                f'width="{bar_w - 2:.1f}" height="{max(h, 0.5):.1f}" '
                f'rx="2" fill="{color}">'
                f'<title>[{r["t0"]:g}, {r["t1"]:g})s {k}: {v:g} '
                f'(miss rate {r["miss_rate"]:g})</title></rect>')
        fr.parts.append(
            f'<text x="{x_mid:.1f}" y="{height - fr.pb + 26}" {FONT} '
            f'font-size="10" fill="{INK_2}" text-anchor="middle">'
            f'{r["t0"]:g}s</text>')
    fr.legend([(k, c) for k, c in series])
    return fr.render()


def metrics_dashboard(mt_or_counts, spec: ME.MetricsSpec | None = None,
                      width: int = 960,
                      title: str = "Telemetry dashboard",
                      replica: int = 0) -> str:
    """The in-jit instrument view: four histogram panels (response,
    wait, slowdown, queue depth at event times) and the per-window SLO
    panel, composed into one SVG.

    Accepts a :class:`~repro_torch.core.metrics.SimMetrics` (a
    ``metrics=True`` state's ``.metrics``, read at ``replica``), or a
    counts dict in the ``fold_tasks_np`` schema plus its ``spec``.
    """
    if isinstance(mt_or_counts, ME.SimMetrics):
        spec = mt_or_counts.spec
        counts = ME.to_numpy(mt_or_counts, replica)
    else:
        counts = mt_or_counts
        spec = spec or ME.DEFAULT_SPEC
    panel_w, panel_h, win_h = width // 2, 210, 230
    panels = [
        _hist_panel(counts["response"], spec, "Response time", SERIES_1,
                    "seconds", panel_w, panel_h),
        _hist_panel(counts["wait"], spec, "Wait time", SERIES_3,
                    "seconds", panel_w, panel_h),
        _hist_panel(counts["slowdown"], spec, "Slowdown", SERIES_2,
                    "response / service", panel_w, panel_h),
        _hist_panel(counts["queue_depth"], spec, "Queue depth @ events",
                    MUTED, "tasks waiting", panel_w, panel_h),
    ]
    height = 28 + 2 * panel_h + win_h
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" viewBox="0 0 {width} {height}" role="img" '
        f'aria-label="{_esc(title)}">',
        f'<rect width="{width}" height="{height}" fill="{SURFACE}"/>',
        f'<text x="16" y="19" {FONT} font-size="14" font-weight="600" '
        f'fill="{INK}">{_esc(title)}</text>',
    ]
    for i, svg in enumerate(panels):
        x, y = (i % 2) * panel_w, 28 + (i // 2) * panel_h
        parts.append(f'<g transform="translate({x},{y})">{svg}</g>')
    parts.append(f'<g transform="translate(0,{28 + 2 * panel_h})">'
                 f'{_slo_window_panel(counts, spec, width, win_h)}</g>')
    return "\n".join(parts) + "\n</svg>"


# --------------------------------------------------------------------------
# Policy scoreboard (learned-vs-heuristic comparison)
# --------------------------------------------------------------------------
def policy_scoreboard(rows: Sequence[dict],
                      metrics: Sequence[str] = ("energy", "missed",
                                                "makespan"),
                      width: int = 960, height: int = 280,
                      title: str = "Policy comparison (lower is better)"
                      ) -> str:
    """Grouped bars per policy: each metric normalized to the worst
    policy's value (1.0 = worst), so energy / missed deadlines / makespan
    share one axis.  ``rows`` is a list of dicts with a ``policy`` key
    plus the metric columns — the rows element of
    ``launch.learn.scoreboard(...)`` (which returns ``(rows, e_scale)``;
    trained policies arrive suffixed with ``*``).  Exact values live in
    each bar's tooltip; the text legend maps metric → color.
    """
    rows = list(rows)
    if not rows:
        return "<svg xmlns='http://www.w3.org/2000/svg'/>"
    colors = {m: c for m, c in zip(metrics, (SERIES_1, SERIES_2, SERIES_3))}
    maxima = {m: max(max(float(r.get(m, 0.0)) for r in rows), 1e-9)
              for m in metrics}
    fr = _Frame(width, height, (0.0, 1.0), (0.0, 1.05), title,
                xlabel="", ylabel="relative to worst policy",
                pad_b=44, x_axis=False)       # categorical x: no time ticks
    plot_w = width - fr.pl - fr.pr
    group_w = plot_w / len(rows)
    bar_w = min(22.0, 0.8 * group_w / max(len(metrics), 1))
    base = fr.sy(0.0)
    for i, r in enumerate(rows):
        x_mid = fr.pl + (i + 0.5) * group_w
        x0 = x_mid - bar_w * len(metrics) / 2
        for j, m in enumerate(metrics):
            v = float(r.get(m, 0.0))
            h = float(base - fr.sy(v / maxima[m]))
            fr.parts.append(
                f'<rect x="{x0 + j * bar_w + 1:.1f}" '
                f'y="{base - h:.1f}" width="{bar_w - 2:.1f}" '
                f'height="{max(h, 0.5):.1f}" rx="2" fill="{colors[m]}">'
                f'<title>{_esc(r["policy"])} {m}: {v:g}</title></rect>')
        fr.parts.append(
            f'<text x="{x_mid:.1f}" y="{height - fr.pb + 26}" {FONT} '
            f'font-size="10" fill="{INK_2}" text-anchor="middle">'
            f'{_esc(r["policy"])}</text>')
    fr.legend([(m, colors[m]) for m in metrics])
    return fr.render()


# --------------------------------------------------------------------------
# Output
# --------------------------------------------------------------------------
def html_report(trace_or_state, dynamics=None,
                title: str = "E2C simulation report",
                scoreboard: Sequence[dict] | None = None,
                workflow=None, metrics=None, replica: int = 0) -> str:
    """One standalone HTML page with all four charts inline.

    ``scoreboard`` (optional): policy-comparison rows (the rows element
    of ``launch.learn.scoreboard(...)``) — appends a
    ``policy_scoreboard`` chart.  ``workflow`` (optional): parent table
    for dependency arrows on the Gantt (see ``gantt``).  ``metrics``
    (optional): a ``SimMetrics`` instrument state (``metrics=True``
    runs) — appends the ``metrics_dashboard`` telemetry view.
    """
    charts = [
        gantt(trace_or_state, dynamics=dynamics, workflow=workflow,
              replica=replica),
        utilization(trace_or_state, replica=replica),
        queue_depth(trace_or_state, replica=replica),
        energy_over_time(trace_or_state, replica=replica),
    ]
    if metrics is not None:
        charts.append(metrics_dashboard(metrics, replica=replica))
    if scoreboard is not None:
        charts.append(policy_scoreboard(scoreboard))
    body = "\n".join(f'<figure style="margin:16px 0">{c}</figure>'
                     for c in charts)
    return (
        "<!DOCTYPE html>\n<html><head><meta charset='utf-8'>"
        f"<title>{_esc(title)}</title></head>\n"
        f"<body style=\"background:{SURFACE};margin:24px;"
        "font-family:system-ui,-apple-system,'Segoe UI',sans-serif\">"
        f"<h1 style='font-size:16px;color:{INK}'>{_esc(title)}</h1>\n"
        f"{body}\n</body></html>\n")


def save(path: str, text: str) -> str:
    """Write an SVG/HTML string; creates parent directories."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path
