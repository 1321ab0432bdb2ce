"""Readings of the program's own spans over a traced window.

The program records spans at its layer boundaries while a profiler session
is on (``visual_rag_tpu_torch/tracing.py``), on the clock of the device
trace (``lib/trace.py``). A reader takes those that lie inside the window
``[trace.t0_ns, trace.t1_ns]``. Idle inside a span name is the device's
idle time in the window (outside the union of its device intervals)
intersected with the union of those spans' intervals: not the trace's rule
of naming a whole gap by the phase open when it began. A program that
records no spans (one older than its tracing module) gives no readings.
:func:`idle_split` splits the window's idle time by every span name
(``bench_port/span_split.py`` prints it after a traced run of a cell).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from bench_port.lib.trace import Interval, union_ns


def program_spans() -> List[Any]:
    """Every span the program holds, device times resolved; none where the
    program has no span recorder."""
    try:
        from visual_rag_tpu_torch import tracing
    except ImportError:
        return []
    return tracing.spans()


def in_window(tr, spans: Sequence[Any]) -> List[Any]:
    """The spans that lie inside the window."""
    return [s for s in spans if tr.t0_ns <= s.start_ns and s.end_ns <= tr.t1_ns]


def window_spans(tr, name: str) -> List[Any]:
    """The program's spans called ``name`` that lie inside the window."""
    return [s for s in in_window(tr, program_spans()) if s.name == name]


def idle_intervals(tr) -> List[Interval]:
    """The window outside the union of the trace's device intervals."""
    edges = [tr.t0_ns] + [x for iv in tr.busy_intervals() for x in iv] + [tr.t1_ns]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def overlap_ns(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """The measure of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_pct(facts: Dict[str, Any], name: str) -> Optional[float]:
    """The device's idle time inside the spans called ``name``, in percent
    of the window; None when the window holds none of them."""
    tr = facts.get("trace")
    if tr is None or tr.t1_ns <= tr.t0_ns:
        return None
    spans = window_spans(tr, name)
    if not spans:
        return None
    covered = union_ns([(s.start_ns, s.end_ns) for s in spans])
    return 100.0 * overlap_ns(idle_intervals(tr), covered) / (tr.t1_ns - tr.t0_ns)


def host_ms_per_page(facts: Dict[str, Any], name: str) -> Optional[float]:
    """The host milliseconds of the spans called ``name`` in the window over
    the pages they counted; None when they counted none."""
    tr = facts.get("trace")
    if tr is None:
        return None
    spans = window_spans(tr, name)
    pages = sum(s.counts.get("pages", 0) for s in spans)
    if not pages:
        return None
    return host_ms(spans) / pages


def idle_split(tr, spans: Sequence[Any]) -> Dict[str, Any]:
    """The window's idle seconds split by span name (a name's idle holds
    that of the spans nested in it), with each name's count, busy seconds
    inside its union and summed host seconds; the idle seconds inside any
    span and their share of all idle; and the idle pieces outside every
    span, longest first, each with its seconds and the trace's phase open
    where it begins."""
    spans = in_window(tr, spans)
    idle, busy = idle_intervals(tr), tr.busy_intervals()
    names = {}
    for name in sorted({s.name for s in spans}):
        mine = [s for s in spans if s.name == name]
        covered = union_ns([(s.start_ns, s.end_ns) for s in mine])
        names[name] = {"n": len(mine), "idle_s": overlap_ns(idle, covered) / 1e9,
                       "busy_s": overlap_ns(busy, covered) / 1e9,
                       "host_s": host_ms(mine) / 1e3}
    covered = union_ns([(s.start_ns, s.end_ns) for s in spans])
    idle_s = sum(e - s for s, e in idle) / 1e9
    inside_s = overlap_ns(idle, covered) / 1e9
    outside = []
    for s0, e0 in idle:
        cur = s0
        for cs, ce in covered:
            if ce <= cur or cs >= e0:
                continue
            if cs > cur:
                outside.append((cur, cs))
            cur = max(cur, ce)
        if cur < e0:
            outside.append((cur, e0))
    outside.sort(key=lambda iv: iv[0] - iv[1])
    return {"window_s": tr.window_s, "idle_s": idle_s, "idle_in_spans_s": inside_s,
            "covered_share": inside_s / idle_s if idle_s else None, "names": names,
            "outside": [[(e - s) / 1e9, tr._phase_at(s)] for s, e in outside]}


def host_ms(spans: Sequence[Any]) -> float:
    """The spans' summed host milliseconds."""
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6


def device_ms(spans: Sequence[Any]) -> float:
    """The spans' summed device milliseconds (those that have one)."""
    return sum(s.device_ms for s in spans if s.device_ms is not None)
