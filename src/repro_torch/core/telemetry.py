"""Host-side pipeline telemetry: span-structured JSONL event logs.

The counterpart of ``repro.core.telemetry``.  The in-loop layer
(``core/metrics.py``) measures the *simulated* system; this module
measures the *pipeline that runs it*: per-run normalize and execute wall
times, per-chunk normalize, dispatch and sync times of a chunked run,
replica counts and the device, for every ``launch/experiment.py`` run.

Records are newline-delimited JSON under ``results/telemetry/``.  Two
record kinds share the envelope ``{"ts": <unix seconds>, "run": <run
id>, "kind": ...}``:

* ``span``: ``{"name", "dur_s", "depth", "span", "parent"}`` plus
  arbitrary user attributes, one record per completed ``span()``
  context, written at exit (children therefore precede parents; the
  ``span``/``parent`` ids reconstruct the tree).
* ``event``: ``{"name"}`` plus attributes, point-in-time counters.

The global log is opt-in and null by default: ``span()`` / ``event()``
on a disabled module are no-ops, so instrumented library code never
pays for telemetry nobody asked for.  Enable it programmatically
(``telemetry.enable(...)``) or by exporting ``REPRO_TELEMETRY=1`` (or
``=/some/dir``).

Unlike the reference's, the log may be written from several threads:
writes take a lock, and each thread keeps its own stack of open spans.
A worker thread parents its spans to a span of the thread that started
it with :func:`adopted`, and holds their records until that thread
writes them (:func:`write_held`), so the file's order of records does
not depend on when the worker finished.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
from typing import Any, Iterator

DEFAULT_DIR = os.path.join("results", "telemetry")
_ENV = "REPRO_TELEMETRY"


def _jsonable(v: Any) -> Any:
    """Best-effort plain-JSON coercion (numpy scalars, paths, tuples)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError, RuntimeError):
            pass
    return str(v)


class TelemetryLog:
    """One JSONL file of spans/events for one logical run.

    Append-only and flushed per record, so a crashed run keeps every
    span that completed.  Thread-safe: one lock around the file, one
    span stack per thread.
    """

    def __init__(self, out_dir: str = DEFAULT_DIR,
                 run_id: str | None = None):
        self.run_id = run_id or time.strftime("%Y%m%d-%H%M%S") \
            + "-" + uuid.uuid4().hex[:6]
        self.out_dir = out_dir
        self.path = os.path.join(out_dir, f"telemetry-{self.run_id}.jsonl")
        self._fh = None
        self._lock = threading.Lock()
        self._local = threading.local()   # .stack, .held per thread
        self.n_records = 0

    def _stack(self) -> list[str]:
        """The calling thread's open span ids, for parenting."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _write(self, rec: dict) -> None:
        held = getattr(self._local, "held", None)
        if held is not None:
            held.append(rec)
            return
        self.write_held([rec])

    def write_held(self, records: list[dict]) -> None:
        """Write records that a worker held (:meth:`adopted`), in order."""
        with self._lock:
            if self._fh is None:
                os.makedirs(self.out_dir, exist_ok=True)
                self._fh = open(self.path, "a", encoding="utf-8")
            for rec in records:
                self._fh.write(json.dumps(rec, separators=(",", ":"))
                               + "\n")
                self.n_records += 1
            self._fh.flush()

    def event(self, name: str, **attrs: Any) -> None:
        """Point-in-time record (counters, config)."""
        self._write({"ts": round(time.time(), 6), "run": self.run_id,
                     "kind": "event", "name": name,
                     **{k: _jsonable(v) for k, v in attrs.items()}})

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[dict]:
        """Timed block; yields a dict for attributes added mid-span.
        The record lands at exit with ``dur_s`` wall time; exceptions
        propagate but still produce a record with ``error`` set."""
        stack = self._stack()
        sid = uuid.uuid4().hex[:8]
        parent = stack[-1] if stack else None
        stack.append(sid)
        extra: dict = {}
        t0 = time.perf_counter()
        try:
            yield extra
        except BaseException as e:
            extra["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            self._write({
                "ts": round(time.time(), 6), "run": self.run_id,
                "kind": "span", "name": name, "dur_s": round(dur, 6),
                "depth": len(stack), "span": sid, "parent": parent,
                **{k: _jsonable(v) for k, v in {**attrs, **extra}.items()},
            })

    def open_span(self) -> str | None:
        """The id of the calling thread's innermost open span."""
        stack = self._stack()
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def adopted(self, parent: str | None) -> Iterator[list[dict]]:
        """In a worker thread: parent the thread's spans to ``parent``
        (an :meth:`open_span` of the thread that started the worker) and
        hold their records in the yielded list instead of writing them;
        that thread writes them with :meth:`write_held` when it collects
        the work."""
        held: list[dict] = []
        self._local.stack = [] if parent is None else [parent]
        self._local.held = held
        try:
            yield held
        finally:
            self._local.stack = []
            self._local.held = None

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# ---------------------------------------------------------------------------
# Module-level current log (null by default)
# ---------------------------------------------------------------------------
_CURRENT: TelemetryLog | None = None
if os.environ.get(_ENV):
    _v = os.environ[_ENV]
    _CURRENT = TelemetryLog(_v if os.sep in _v or _v.startswith(".")
                            else DEFAULT_DIR)


def enable(out_dir: str = DEFAULT_DIR,
           run_id: str | None = None) -> TelemetryLog:
    """Install (and return) a fresh module-level log."""
    global _CURRENT
    if _CURRENT is not None:
        _CURRENT.close()
    _CURRENT = TelemetryLog(out_dir, run_id)
    return _CURRENT


def disable() -> None:
    global _CURRENT
    if _CURRENT is not None:
        _CURRENT.close()
    _CURRENT = None


def current() -> TelemetryLog | None:
    return _CURRENT


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[dict]:
    """``current().span(...)`` or a free no-op when telemetry is off."""
    if _CURRENT is None:
        yield {}
    else:
        with _CURRENT.span(name, **attrs) as extra:
            yield extra


def event(name: str, **attrs: Any) -> None:
    """``current().event(...)`` or a free no-op when telemetry is off."""
    if _CURRENT is not None:
        _CURRENT.event(name, **attrs)


def open_span() -> str | None:
    """``current().open_span()``, None when telemetry is off."""
    return None if _CURRENT is None else _CURRENT.open_span()


@contextlib.contextmanager
def adopted(parent: str | None) -> Iterator[list[dict]]:
    """``current().adopted(parent)``; yields an empty list that stays
    empty when telemetry is off."""
    if _CURRENT is None:
        yield []
    else:
        with _CURRENT.adopted(parent) as held:
            yield held


def write_held(records: list[dict]) -> None:
    """``current().write_held(records)``; a no-op when telemetry is off."""
    if _CURRENT is not None and records:
        _CURRENT.write_held(records)


def read_jsonl(path: str) -> list[dict]:
    """Parse one telemetry file back into records (for tests/analysis)."""
    with open(path, encoding="utf-8") as fh:
        return [json.loads(line) for line in fh if line.strip()]
