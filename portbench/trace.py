"""The traced window: torch.profiler around a few calls, reduced to device
activities and host operations in the window.

The window is a user annotation around the calls, closed by a device
synchronize, so that its ends are on the trace's own clock. The device is
busy in the union of its activities (kernels, copies, sets), clipped to the
window; the idle share is the rest. Each idle gap is labelled by the
innermost host operation running at its middle, "python" where none runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

WINDOW = "portbench.window"
DINOV2_NAMESPACE = "dinov2::"  # every hand-written kernel of the port sits in it


@dataclass
class Activity:
    name: str
    start_ns: int
    end_ns: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclass
class Trace:
    calls: int  # calls (or steps) in the window
    start_ns: int
    end_ns: int
    device: list[Activity] = field(default_factory=list)  # in the window, in start order
    host: list[Activity] = field(default_factory=list)

    @property
    def window_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def kernels(self) -> list[Activity]:
        return [a for a in self.device if not is_copy(a.name) and not is_set(a.name)]

    @property
    def host_copies(self) -> list[Activity]:
        """Copies between the host and the device (not device to device)."""
        return [a for a in self.device if is_copy(a.name) and ("HtoD" in a.name or "DtoH" in a.name)]

    def busy_intervals(self) -> list[tuple[int, int]]:
        merged: list[list[int]] = []
        for a in sorted(self.device, key=lambda a: a.start_ns):
            lo, hi = max(a.start_ns, self.start_ns), min(a.end_ns, self.end_ns)
            if hi <= lo:
                continue
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return [(lo, hi) for lo, hi in merged]

    def busy_ns(self) -> int:
        return sum(hi - lo for lo, hi in self.busy_intervals())

    def idle_gaps(self) -> list[tuple[str, int]]:
        """(label, ns) of each gap between busy intervals in the window."""
        edges = [self.start_ns]
        for lo, hi in self.busy_intervals():
            edges += [lo, hi]
        edges.append(self.end_ns)
        gaps = [(lo, hi) for lo, hi in zip(edges[::2], edges[1::2]) if hi > lo]
        # one sweep: host operations on one thread nest, so the innermost
        # one running at t is the latest started of those still open
        host = sorted(self.host, key=lambda a: a.start_ns)
        stack: list[Activity] = []
        i = 0
        out = []
        for lo, hi in gaps:
            t = (lo + hi) // 2
            while i < len(host) and host[i].start_ns <= t:
                while stack and stack[-1].end_ns <= host[i].start_ns:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1].end_ns <= t:
                stack.pop()
            out.append((stack[-1].name if stack else "python", hi - lo))
        return out


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


def is_set(name: str) -> bool:
    return name.startswith("Memset")


def is_port_kernel(name: str) -> bool:
    return DINOV2_NAMESPACE in name


def record(call, calls: int) -> Trace:
    """Run `call(i)` for i < calls under the profiler; the window's trace."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            for i in range(calls):
                call(i)
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    marks = [e for e in events
             if e.name() == WINDOW and e.device_type() == torch.autograd.DeviceType.CPU]
    if not marks:
        raise RuntimeError("the profiler recorded no window")
    mark = marks[0]
    trace = Trace(calls=calls, start_ns=mark.start_ns(),
                  end_ns=mark.start_ns() + mark.duration_ns())
    for e in events:
        a = Activity(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.name() == WINDOW or e.is_user_annotation():
            continue  # the window's own range, which the profiler also puts on the device
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if trace.start_ns <= a.start_ns < trace.end_ns:
                trace.device.append(a)
        elif e.start_thread_id() == mark.start_thread_id():
            trace.host.append(a)
    trace.device.sort(key=lambda a: a.start_ns)
    return trace


def top_device_ops(trace: Trace, n: int = 10) -> list[list]:
    """[name, seconds] of the device operations that took most time."""
    totals: dict[str, int] = {}
    for a in trace.device:
        totals[a.name] = totals.get(a.name, 0) + a.ns
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], ns / 1e9] for name, ns in ranked]


def top_idle_gaps(trace: Trace, n: int = 10) -> list[list]:
    """[host operation, seconds] of the idle time, summed by what the host
    was doing, longest first."""
    totals: dict[str, int] = {}
    for label, ns in trace.idle_gaps():
        totals[label] = totals.get(label, 0) + ns
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], ns / 1e9] for name, ns in ranked]
