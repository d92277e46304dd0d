"""The program's host spans in a traced window: host operations named
`dinov2_tpu_torch.<layer>.<stage>` (the port's utils/timing.py::span).
The port's operators, `dinov2_tpu_torch::<op>` in the dispatcher, are not
spans. Spans on one thread nest, so the innermost one open at a time is the
latest started of those still open."""

from __future__ import annotations

PREFIX = "dinov2_tpu_torch."


def is_span(name: str) -> bool:
    return name.startswith(PREFIX)


def _named(trace, names) -> list:
    return [a for a in trace.host if a.name in names]


def covered_ns(trace, names) -> int | None:
    """ns of the window that the union of the spans named `names` covers;
    None where no such span is in the trace."""
    spans = _named(trace, names)
    if not spans:
        return None
    total, reach = 0, trace.start_ns
    for a in sorted(spans, key=lambda a: a.start_ns):
        lo, hi = max(a.start_ns, reach), min(a.end_ns, trace.end_ns)
        if hi > lo:
            total += hi - lo
            reach = hi
    return total


def idle_gaps(trace) -> list[tuple[int, int]]:
    """(start, end) of each gap between the device's busy intervals in the
    window, as trace.Trace.idle_gaps takes them."""
    edges = [trace.start_ns]
    for lo, hi in trace.busy_intervals():
        edges += [lo, hi]
    edges.append(trace.end_ns)
    return [(lo, hi) for lo, hi in zip(edges[::2], edges[1::2]) if hi > lo]


def innermost(spans, t: int):
    """The innermost of `spans` open at t, or None."""
    open_ = [a for a in spans if a.start_ns <= t < a.end_ns]
    return max(open_, key=lambda a: a.start_ns) if open_ else None


def idle_ns(trace, names) -> int | None:
    """ns of the device's idle gaps whose middle lies in a span named in
    `names` that is the innermost span open there; None where no such span
    is in the trace."""
    if not _named(trace, names):
        return None
    spans = [a for a in trace.host if is_span(a.name)]
    total = 0
    for lo, hi in idle_gaps(trace):
        span = innermost(spans, (lo + hi) // 2)
        if span is not None and span.name in names:
            total += hi - lo
    return total
