"""The measured window, its spans and, in a traced run, its device trace.

``Recorder.run(cell, seconds)`` resets the program's launch counters
(``tpufhe_torch.kernels.LAUNCHES``), runs the cell's window and returns
the ``Window`` the metric readers read. The cell marks its spans with
``Recorder.span(name)``: a host-clock duration each, and in a traced run
also its wall-clock bounds, the clock of the profiler's timeline, by
which an idle gap of the card is named.

A traced run (--trace 1) runs the window under ``torch.profiler`` (the
CUDA activity alone, so the host's own work is not slowed by recording
its operations) and records every launch of a port kernel that has
a file in fhebench/roofline/: the file names the program's wrapper that
launches it (PATCH), which the recorder wraps to read the launch's shape,
and the kernel's names in the device trace (TRACE). ``TraceSummary``
reduces the trace: busy seconds, the window, each port kernel's measured
time, the rest (torch's elementwise kernels, gathers, copies), the idle
gaps, and the bounds of the recorded launches.
"""

from __future__ import annotations

import contextlib
import importlib
import pkgutil
import re
import sys
import time
from dataclasses import dataclass, field

from fhebench import roofline
from fhebench.roofline import peaks


@dataclass
class Window:
    """What one window did: operations completed, requests attempted and
    failed, its length, per-request latencies (ms) and span durations
    (ms), and the program's kernel launches over it."""

    ops: int = 0
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    latencies_ms: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)
    setup_s: float = 0.0
    trace: "TraceSummary | None" = None


def roofline_modules() -> dict:
    """{port kernel name: its module in fhebench/roofline/}."""
    out = {}
    for info in pkgutil.iter_modules(roofline.__path__):
        mod = importlib.import_module(f"fhebench.roofline.{info.name}")
        if hasattr(mod, "PATCH"):
            out[info.name] = mod
    return out


class Recorder:
    def __init__(self, traced: bool, on_card: bool = True):
        self.traced = traced
        self.on_card = on_card
        self.window = Window()
        self.calls: list = []
        self._prof = None
        self.t_start = 0.0
        self.marks: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        """A host-clock span of the window; the cell ends its work on a
        synchronize inside it where the span is to cover the device."""
        t0, w0 = time.perf_counter(), time.time_ns()
        yield
        self.window.spans.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3)
        if self.traced:
            self.marks.append((w0, time.time_ns(), name))

    @contextlib.contextmanager
    def _recording(self):
        """Wrap each roofline file's PATCH target to record its launches."""
        saved = []
        for kernel, mod in roofline_modules().items():
            owner_name, attr = mod.PATCH
            owner = importlib.import_module(owner_name.split(":")[0])
            if ":" in owner_name:
                owner = getattr(owner, owner_name.split(":")[1])
            orig = getattr(owner, attr)

            def wrapped(*args, _orig=orig, _mod=mod, _k=kernel, **kwargs):
                self.calls.append(
                    (_k, peaks.bound(*_mod.cost(_mod.shape(*args, **kwargs)))))
                return _orig(*args, **kwargs)

            saved.append((owner, attr, orig))
            setattr(owner, attr, wrapped)
        try:
            yield
        finally:
            for owner, attr, orig in saved:
                setattr(owner, attr, orig)

    def run(self, cell, seconds: float) -> Window:
        from tpufhe_torch import kernels

        kernels.reset_launches()
        with contextlib.ExitStack() as stack:
            if self.traced:
                from torch.profiler import ProfilerActivity, profile

                stack.enter_context(self._recording())
                self._prof = stack.enter_context(profile(activities=[
                    ProfilerActivity.CUDA if self.on_card
                    else ProfilerActivity.CPU]))
            self.t_start, w0 = time.perf_counter(), time.time_ns()
            cell.window(seconds, self)
            self.window.window_s = time.perf_counter() - self.t_start
            self.bounds = (w0, time.time_ns())
        self.window.launches = {k: v for k, v in kernels.LAUNCHES.items()
                                if v}
        if self._prof is not None:
            t_stopped = time.perf_counter()
            self.window.trace = TraceSummary(self._prof, self.calls,
                                             self.bounds, self.marks)
            self._prof = None
            t_end = time.perf_counter()
            print(f"fhebench: the profiler stopped in "
                  f"{t_stopped - self.t_start - self.window.window_s:.1f} s "
                  f"and the trace was reduced in {t_end - t_stopped:.1f} s",
                  file=sys.stderr)
        return self.window


def port_kernel(name: str, patterns: dict) -> str | None:
    for kernel, pattern in patterns.items():
        if pattern.search(name):
            return kernel
    return None


class TraceSummary:
    """The device trace of one window, reduced."""

    def __init__(self, prof, calls: list, bounds: tuple, marks: list):
        from torch.autograd import DeviceType

        mods = roofline_modules()
        patterns = {k: re.compile(m.TRACE) for k, m in mods.items()}
        w0, w1 = bounds
        dev = sorted((e.start_ns(), e.end_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() != DeviceType.CPU
                     and e.duration_ns() > 0)
        # the profiler runs around the window alone, so every device event
        # is the window's; the device clock may sit a little off the host's,
        # so an event past the window's host clock bounds is clipped to them
        outside = sum(d[0] < w0 or d[1] > w1 for d in dev)
        if outside:
            print(f"fhebench: {outside} of {len(dev)} device events clipped "
                  "to the window's host clock bounds", file=sys.stderr)
        spans = marks
        self.window_s = (w1 - w0) / 1e9
        self.port_ns: dict = {}
        self.port_count: dict = {}
        self.other_ns = 0
        self.by_name: dict = {}
        busy, end = 0, w0
        gaps = []
        kernel_of: dict = {}
        for s, e, name in dev:
            if name not in kernel_of:
                kernel_of[name] = port_kernel(name, patterns)
            kernel = kernel_of[name]
            d = e - s
            s, e = min(max(s, w0), w1), min(max(e, w0), w1)
            if kernel is None:
                self.other_ns += d
                label = name[:80]
            else:
                self.port_ns[kernel] = self.port_ns.get(kernel, 0) + d
                self.port_count[kernel] = self.port_count.get(kernel, 0) + 1
                label = kernel
            self.by_name[label] = self.by_name.get(label, 0) + d
            if s >= end:
                gaps.append((s - end, end))
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        gaps.append((w1 - end, end))
        self.busy_s = busy / 1e9
        self.dev_ns = sum(self.port_ns.values()) + self.other_ns
        spans.sort()
        self.gaps = []
        for length, at in sorted(gaps, reverse=True)[:10]:
            inner = [sp for sp in spans if sp[0] <= at < sp[1]]
            label = min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner \
                else "outside any span"
            self.gaps.append([label, length / 1e9])
        self.call_count: dict = {}
        self.bound_s: dict = {}
        self.bound_by: dict = {}
        for kernel, (seconds, by) in calls:
            self.call_count[kernel] = self.call_count.get(kernel, 0) + 1
            self.bound_s[kernel] = self.bound_s.get(kernel, 0.0) + seconds
            self.bound_by.setdefault(kernel, set()).add(by)
        for kernel in set(self.call_count) | set(self.port_count):
            if self.call_count.get(kernel) != self.port_count.get(kernel):
                print(f"fhebench: {kernel}: {self.call_count.get(kernel, 0)} "
                      f"recorded launches, {self.port_count.get(kernel, 0)} "
                      "in the trace", file=sys.stderr)

    def bound_of_traced(self) -> float | None:
        """The least time of the port kernels' launches in the trace: each
        kernel's recorded bounds scaled by its launches in the trace over
        those recorded. None unless every kernel in the trace was
        recorded, and the two counts of each differ by at most 0.1 % (a
        profiler may lose a few events of a long trace)."""
        if not self.port_count:
            return None
        total = 0.0
        for kernel, traced in self.port_count.items():
            recorded = self.call_count.get(kernel, 0)
            if not recorded or abs(traced - recorded) > recorded / 1000:
                return None
            total += self.bound_s[kernel] * traced / recorded
        return total

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v / 1e9] for k, v in ops],
                "idle_gaps": self.gaps}
