"""Observability: logging, byte formatting, and the program's one tracer.

The port's copy of tpufhe/utils/obs.py, the counterpart of the
reference's example-level surface: `log` + `env_logger` initialization
(examples/sealpir.rs:38, examples/mulpir.rs:49), the `timeit!` /
`timeit_n!` macros (examples/util.rs:18-48) and `indicatif::HumanBytes`
(examples/mulpir.rs:104-111). The library stays silent; the example
applications opt in.

TPUFHE_LOG=debug|info|warning|error sets the level of the "tpufhe_torch"
logger tree (env_logger's RUST_LOG).

The tracer: ``span(name)`` marks a stretch of the program and ``count(name)``
counts an event. Both record only while recording is on: inside ``with
recording():``, or while a ``torch.profiler`` session is active (the flag
``torch.autograd.profiler`` keeps for ``record_function``; a new session
starts a new recording). Off, a span is a shared no-op and a count returns
at once, each after one check. A span records its id, its parent (the
enclosing span), its name and its host bounds on ``time.time_ns()``, the
clock onto which ``fhebench/trace.py`` puts the profiler's device events; a
span opened with ``device=True`` also records a CUDA timing event on the
current stream (the stream the kernels launch on) at entry and exit, turned
into ``time.time_ns()`` time through anchor events when the recording is
read (``Recording.resolve``). Nothing is written into the profiler's own
trace, and nothing in a span synchronizes. ``export_chrome_trace`` writes
the latest recording for a trace viewer. Kernel launches stay counted by
``kernels.count`` (always on); a recording reports them among its counters
as ``launch.<kernel>``.

One recording is open at a time and spans nest by a single stack: trace
one host thread.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import time
from contextlib import contextmanager

import torch.autograd.profiler as _profiler

logger = logging.getLogger("tpufhe_torch")

# the operator's switch: True inside `with recording():`
_on = False
# the open recording, and the latest one opened (read after it closes)
_open = None
_latest = None


def init_logging(default: str | None = None) -> logging.Logger:
    """env_logger::init: configure the tpufhe_torch logger from TPUFHE_LOG
    (falling back to `default`, or warning)."""
    level_name = os.environ.get("TPUFHE_LOG", default or "warning").upper()
    level = getattr(logging, level_name, logging.WARNING)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("[%(asctime)s %(levelname)s %(name)s] %(message)s",
                              "%H:%M:%S"))
        logger.addHandler(h)
    logger.setLevel(level)
    return logger


def human_bytes(n: int) -> str:
    """indicatif::HumanBytes: 1536 -> '1.50 KiB'."""
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            if unit == "B":
                return f"{int(n)} B"
            return f"{n:.2f} {unit}"
        n /= 1024
    raise AssertionError("unreachable")


class Recording:
    """What one recording holds: ``spans`` (closed ``Span`` objects in the
    order they closed), ``counters`` ({name: count}, with the kernels'
    launches over the recording as ``launch.<kernel>`` once it is closed)
    and, on a CUDA device, the anchor of its device times."""

    def __init__(self, by_profiler: bool):
        import torch

        from tpufhe_torch import kernels

        self.by_profiler = by_profiler
        self.spans: list = []
        self.counters: dict = {}
        self.closed = False
        self._stack: list = []
        self._next = 0
        self._quiet = 0
        self._launches = dict(kernels.LAUNCHES)
        self._anchor = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._anchor = (event, time.time_ns())

    def close(self) -> None:
        from tpufhe_torch import kernels

        if self.closed:
            return
        self.closed = True
        for name, n in kernels.LAUNCHES.items():
            if n != self._launches.get(name, 0):
                self.counters[f"launch.{name}"] = n - self._launches.get(name, 0)

    def children(self, span: "Span") -> list:
        return [s for s in self.spans if s.parent == span.id]

    def self_ns(self, span: "Span") -> int:
        """The span's host time less its children's: its self time (the
        spans of one thread nest, so children never overlap)."""
        return (span.end_ns - span.start_ns) - sum(
            c.end_ns - c.start_ns for c in self.children(span))

    def resolve(self) -> None:
        """Turn the device-timed spans' CUDA events into ``device`` bounds
        on the ``time.time_ns()`` clock: each event's distance from the
        start anchor, scaled by the host's time over the device's between
        that anchor and a second one recorded here, after a synchronize
        (so the device clock's drift against the host's is taken out)."""
        if self._anchor is None or not any(s._events for s in self.spans):
            return
        import torch

        torch.cuda.synchronize()
        anchor, anchor_ns = self._anchor
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end_ns = time.time_ns()
        end.synchronize()
        scale = (end_ns - anchor_ns) / (anchor.elapsed_time(end) * 1e6)
        for s in self.spans:
            if s._events:
                e0, e1 = s._events
                start = anchor_ns + round(anchor.elapsed_time(e0) * 1e6 * scale)
                s.device = (start,
                            start + round(e0.elapsed_time(e1) * 1e6 * scale))
                s._events = None


class Span:
    """One span of a recording, usable once as a context manager:
    ``start_ns`` / ``end_ns`` on the host clock, ``device`` the
    (start_ns, end_ns) of its device interval once the recording is
    resolved (None for a host-only span, and on the CPU)."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "device",
                 "_events", "_rec", "_timed", "_want")

    def __init__(self, name: str, rec: Recording | None, device: bool = False):
        self.name = name
        self._rec = rec
        self._want = device
        self._timed = device and rec is not None and rec._anchor is not None
        self.id = self.parent = None
        self.device = self._events = None
        self.start_ns = self.end_ns = 0

    def __enter__(self):
        rec = self._rec
        if rec is not None:
            self.id = rec._next
            rec._next += 1
            self.parent = rec._stack[-1] if rec._stack else None
            rec._stack.append(self.id)
            if self._timed:
                import torch

                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        rec = self._rec
        if rec is not None:
            if self._events:
                self._events[1].record()
            rec._stack.pop()
            rec.spans.append(self)
        return False

    def __call__(self, fn):
        return _Off(self.name, self._want)(fn)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Off:
    """The shared span of a name while recording is off: does nothing as a
    context manager, and as a decorator opens a span of its name on each
    call made while recording is on."""

    __slots__ = ("name", "device")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name, device = self.name, self.device

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name, device):
                return fn(*args, **kwargs)

        return wrapped


_OFF: dict = {False: {}, True: {}}


def _recording() -> Recording:
    """The open recording while recording is on: the operator's, or the
    profiler session's, opened by the session's first span or count (a
    session that starts before any span or count of the program has read
    the last one's recording continues it)."""
    global _open, _latest
    if _open is None:
        _open = _latest = Recording(by_profiler=True)
    return _open


def _closed_profiler_recording() -> None:
    """Close the profiler's recording once its session has ended."""
    global _open
    if (_open is not None and _open.by_profiler
            and not _profiler._is_profiler_enabled):
        _open.close()
        _open = None


def span(name: str, device: bool = False):
    """A span of the program, as a context manager or a decorator. Off: the
    shared no-op of the name. device=True also times the span on the
    device's clock (CUDA events), where the recording has a device."""
    if not (_on or _profiler._is_profiler_enabled):
        off = _OFF[device].get(name)
        if off is None:
            off = _OFF[device][name] = _Off(name, device)
        return off
    return Span(name, _recording(), device)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the open recording (off: nothing)."""
    if not (_on or _profiler._is_profiler_enabled):
        return
    rec = _recording()
    if not rec._quiet:
        rec.counters[name] = rec.counters.get(name, 0) + n


def uncounted(fn):
    """Run `fn` with counting paused: a kernel's plain version, whose
    elementwise torch work stands for the kernel and is not glue."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not (_on or _profiler._is_profiler_enabled):
            return fn(*args, **kwargs)
        rec = _recording()
        rec._quiet += 1
        try:
            return fn(*args, **kwargs)
        finally:
            rec._quiet -= 1

    return wrapped


@contextmanager
def recording():
    """Record spans and counters inside the block (the operator's switch);
    yields the Recording, closed at the end of the block."""
    global _on, _open, _latest
    if _open is not None:
        _open.close()
    rec = _open = _latest = Recording(by_profiler=False)
    _on = True
    try:
        yield rec
    finally:
        _on = False
        rec.close()
        _open = None


def latest() -> Recording | None:
    """The latest recording (closed first if its profiler session has
    ended), or None if nothing was ever recorded."""
    _closed_profiler_recording()
    return _latest


HOST_TID, DEVICE_TID = 0x7F000001, 0x7F000002


def export_chrome_trace(path: str, like: str | None = None) -> int:
    """Write the latest recording as Chrome-trace JSON: one complete event
    a span on the track "tpufhe_torch spans (host)", and one a resolved
    device interval on "tpufhe_torch spans (device)", in the process's pid.
    `like`: the Chrome trace torch.profiler's export_chrome_trace wrote of
    the same window; its timestamp base (``baseTimeNanoseconds``) becomes
    this file's, so the two line up when loaded together (without it the
    timestamps count from the epoch). Returns the number of span events."""
    rec = latest()
    if rec is None:
        raise RuntimeError("export_chrome_trace: nothing was recorded")
    rec.resolve()
    base = 0
    if like is not None:
        with open(like) as f:
            base = int(json.load(f).get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
               "args": {"name": f"tpufhe_torch spans ({track})"}}
              for tid, track in ((HOST_TID, "host"), (DEVICE_TID, "device"))]

    def complete(s, tid, bounds):
        return {"ph": "X", "cat": "tpufhe_torch", "name": s.name, "pid": pid,
                "tid": tid, "ts": (bounds[0] - base) / 1e3,
                "dur": (bounds[1] - bounds[0]) / 1e3,
                "args": {"id": s.id, "parent": s.parent}}

    spans = [complete(s, HOST_TID, (s.start_ns, s.end_ns)) for s in rec.spans]
    events += spans
    events += [complete(s, DEVICE_TID, s.device) for s in rec.spans
               if s.device is not None]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": base}, f)
    return len(spans)


@contextmanager
def timeit(label: str, report: dict | None = None, key: str | None = None,
           n: int = 1):
    """timeit! / timeit_n!: logs the (per-iteration) wall time of the block
    at info level and records its seconds into report[key or label] when a
    report is given; the block is a span of `label` (recorded while
    recording is on). The block must end with the work done (on a CUDA
    device, a synchronize)."""
    block = Span(label, _recording() if _on or _profiler._is_profiler_enabled
                 else None)
    try:
        with block:
            yield
    finally:
        dt = block.seconds / max(n, 1)
        if dt >= 1.0:
            disp = f"{dt:.2f} s"
        elif dt >= 1e-3:
            disp = f"{dt * 1e3:.2f} ms"
        else:
            disp = f"{dt * 1e6:.0f} us"
        logger.info("%s: %s", label, disp)
        if report is not None:
            report[key or label] = dt
