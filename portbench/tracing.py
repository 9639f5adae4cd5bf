"""The traced run's profiler and what is read from its events.

``Tracer`` records the measured window with ``torch.profiler``'s kineto
back end (CPU ops and CUDA activity) and keeps the raw events: the
Python-side parse of the public ``profile`` object costs minutes on a
window of a million events, so the events are read here directly. The
harness's spans are ``record_function`` ranges opened from its own files:
``portbench.window`` around the measured window and ``portbench.unit``
around each step or request. The program opens its own while a profiler
records, named ``repro_torch.<layer>.<what>`` (``src/repro_torch/spans.py``).

Only those spans, the autograd engine's node ranges (its backward) and
the CUDA runtime's calls are recorded on the host, not every aten op. A device
operation belongs to a host range when the host call that launched it (the
runtime call of the same correlation id, else the host event it is linked
to) started inside that range on the same thread.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses

from portbench import yardstick

WINDOW = "portbench.window"
UNIT = "portbench.unit"
PROGRAM = "repro_torch."       # the prefix of the program's spans
BACKWARD = "backward"          # the ranges of the autograd engine's nodes

# device-side records that are not work on the device
_NOT_WORK = ("Context Sync", "Stream Sync", "Event Sync", "Stream Wait Event",
             "Device Sync")


def range_(name: str):
    """A named span on the profiler's timeline (a no-op when untraced)."""
    import torch
    return torch.profiler.record_function(name)


@dataclasses.dataclass
class Trace:
    """What the harness keeps of a traced window (times in seconds on the
    profiler's clock)."""
    window: tuple                 # (start, end) of the window's range
    main_tid: int
    device: list                  # [(name, start, end, launch_tid, launch_t)]
    cpu: list                     # [(name, start, end, tid)]
    backward: list                # [(start, end, tid)] of autograd nodes

    def ranges(self, name: str) -> list:
        """[(start, end, tid)] of the host events named ``name``
        (``BACKWARD``: the autograd engine's node ranges)."""
        if name == BACKWARD:
            return self.backward
        return [(s, e, t) for n, s, e, t in self.cpu if n == name]

    def busy(self) -> list:
        """Merged device intervals inside the window."""
        lo, hi = self.window
        return [(max(s, lo), min(e, hi))
                for s, e in yardstick.union((s, e) for _, s, e, _, _ in
                                            self.device)
                if e > lo and s < hi]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def launched_in(self, ranges: list) -> list:
        """Device operations whose launch lies inside one of ``ranges``
        ([(start, end, tid)]) on the range's thread."""
        by_tid = collections.defaultdict(list)
        for s, e, t in ranges:
            by_tid[t].append((s, e))
        merged = {t: yardstick.union(v) for t, v in by_tid.items()}
        starts = {t: [s for s, _ in v] for t, v in merged.items()}
        out = []
        for op in self.device:
            tid, t = op[3], op[4]
            if tid not in merged or t is None:
                continue
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and merged[tid][i][1] >= t:
                out.append(op)
        return out

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time
        in the window, summed by name."""
        lo, hi = self.window
        total: dict = collections.Counter()
        for name, s, e, _, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                total[name] += e - s
        return [[n, v] for n, v in total.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host ran, seconds]] of the idle time in the window:
        each gap between device operations is named by the innermost host
        event on the main thread at its middle (one thread's events nest),
        and summed by that name."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy() for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        main = sorted((s, -e, n) for n, s, e, t in self.cpu
                      if t == self.main_tid and n not in (WINDOW, UNIT))
        total: dict = collections.Counter()
        stack, j = [], 0
        for s, e in gaps:
            mid = 0.5 * (s + e)
            while j < len(main) and main[j][0] <= mid:
                stack.append((-main[j][1], main[j][2]))
                j += 1
            while stack and stack[-1][0] < mid:
                stack.pop()
            total[stack[-1][1] if stack else "host, no recorded call"] += \
                e - s
        return [[n, v] for n, v in total.most_common(top)]


class Tracer:
    """Kineto profiling of the measured window, or nothing (``on=False``)."""

    def __init__(self, on: bool, cuda: bool):
        self.on, self.cuda = on, cuda
        self.trace = None

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, _disable_profiler,
                                    _enable_profiler, _prepare_profiler)
        from torch._C._profiler import RecordScope, _ExperimentalConfig
        acts = {ProfilerActivity.CPU}
        if self.cuda:
            acts.add(ProfilerActivity.CUDA)
        config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                False, False, _ExperimentalConfig())
        _prepare_profiler(config, acts)
        # user spans and the autograd engine's backward ranges only: with
        # every aten op recorded the host of a training step runs twice as
        # long and the device's idle share reads the profiler's cost
        _enable_profiler(config, acts, {RecordScope.USER_SCOPE,
                                        RecordScope.BACKWARD_FUNCTION})
        try:
            with range_(WINDOW):
                yield
        finally:
            self.trace = read_events(_disable_profiler().events())


def read_events(events) -> Trace:
    """A ``Trace`` of kineto events (``_KinetoEvent``)."""
    from torch._C._profiler import RecordScope
    node = int(RecordScope.BACKWARD_FUNCTION)
    cpu, dev, ops, launches, backward = [], [], {}, {}, []
    window, main = None, None
    for ev in events:
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        name = ev.name()
        if ev.device_type().name == "CPU":
            tid = ev.start_thread_id()
            cpu.append((name, s, e, tid))
            if int(ev.scope()) == node:
                backward.append((s, e, tid))
            # runtime calls (cudaLaunchKernel, ...) carry the correlation
            # id of what they launched; CPU ops their own id
            table = launches if name.startswith("cu") else ops
            table.setdefault(ev.correlation_id(), (s, tid))
            if name == WINDOW:
                window, main = (s, e), tid
        elif not ev.is_user_annotation() and not name.startswith(_NOT_WORK):
            dev.append((name, s, e, ev.correlation_id(),
                        ev.linked_correlation_id()))
    if window is None:
        raise RuntimeError("the trace holds no portbench.window range")
    device = []
    for name, s, e, corr, linked in dev:
        t, tid = launches.get(corr) or ops.get(linked) or (None, None)
        device.append((name, s, e, tid, t))
    return Trace(window=window, main_tid=main, device=device, cpu=cpu,
                 backward=backward)
