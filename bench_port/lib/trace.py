"""The device trace of a measured window, and what the readers take from it.

``torch.profiler`` traces the card's kernels, copies and sets over the
whole window (CUDA activity only: the host's operators are not recorded,
which keeps a long window's trace small). The harness marks its own host
phases with :meth:`DeviceTrace.phase`; an idle gap on the device is named
by the phase that was open when it began.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]  # ns, the profiler's clock (wall time since the epoch)


def union_ns(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class DeviceTrace:
    """Profile the device over a window when ``enabled`` (a no-op otherwise).

    After the window: ``busy_s`` (the union of device intervals, clipped to
    the window), ``window_s``, ``kernel_seconds(names)`` (summed device time
    of the kernels whose names contain any of ``names``), ``launches``, and
    :meth:`breakdown`."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events: List[Tuple[str, int, int]] = []  # (name, start ns, end ns)
        self.phases: List[Tuple[str, int, int]] = []
        self.t0_ns = self.t1_ns = 0
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self._collect()
        return False

    def _collect(self) -> None:
        from torch.autograd import DeviceType

        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA or ev.duration_ns() <= 0:
                continue
            s = ev.start_ns()
            self.events.append((ev.name(), s, s + ev.duration_ns()))
        self._prof = None

    @contextlib.contextmanager
    def phase(self, name: str):
        """Mark a host phase of the harness (for naming idle gaps)."""
        if not self.enabled:
            yield
            return
        s = time.time_ns()
        try:
            yield
        finally:
            self.phases.append((name, s, time.time_ns()))

    # -- readings ------------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_intervals(self) -> List[Interval]:
        clipped = [(max(s, self.t0_ns), min(e, self.t1_ns)) for _, s, e in self.events]
        return union_ns([iv for iv in clipped if iv[1] > iv[0]])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    @property
    def launches(self) -> int:
        return len(self.events)

    def kernel_seconds(self, names: Sequence[str]) -> float:
        return sum(e - s for n, s, e in self.events if any(x in n for x in names)) / 1e9

    def _phase_at(self, t_ns: int) -> str:
        best: Optional[Tuple[str, int, int]] = None
        for ph in self.phases:  # the innermost (latest-starting) open phase
            if ph[1] <= t_ns < ph[2] and (best is None or ph[1] >= best[1]):
                best = ph
        return best[0] if best else "untracked host"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps by the host phase open when each began: each at most ``top``."""
        by_name: Dict[str, int] = defaultdict(int)
        for n, s, e in self.events:
            by_name[n] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [self.t0_ns] + [x for iv in busy for x in iv] + [self.t1_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[n[:120], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[self._phase_at(s), (e - s) / 1e9] for s, e in longest],
        }

    def idle_by_phase(self) -> Dict[str, float]:
        """Seconds of device idleness summed by the host phase open when
        each idle gap began."""
        busy = self.busy_intervals()
        edges = [self.t0_ns] + [x for iv in busy for x in iv] + [self.t1_ns]
        out: Dict[str, float] = defaultdict(float)
        for i in range(0, len(edges) - 1, 2):
            if edges[i + 1] > edges[i]:
                out[self._phase_at(edges[i])] += (edges[i + 1] - edges[i]) / 1e9
        return dict(out)
