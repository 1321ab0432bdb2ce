"""Shared arithmetic of the per-layer readers (``bench_port/metrics/``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from bench_port.lib.peaks import least_seconds


def idle_pct(facts: Dict[str, Any]) -> Optional[float]:
    """The share of the traced window in which no kernel, copy or set was in
    flight on the device (the union of the trace's device intervals)."""
    tr = facts.get("trace")
    if tr is None or not tr.events or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(least_s: float, kernel_s: float) -> Optional[float]:
    """A kernel's least time over its summed device time, in percent; None
    when the trace holds none of it."""
    if kernel_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / kernel_s


def least(nbytes: float, ops: float) -> float:
    return least_seconds(nbytes, ops, "bf16")


def mfu_pct(facts: Dict[str, Any]) -> Optional[float]:
    """Model FLOPs of the traced window's work over (window x the bf16 peak)."""
    from bench_port.lib.peaks import PEAK_OPS

    tr, flops = facts.get("trace"), facts.get("model_flops")
    if tr is None or not flops or tr.window_s <= 0:
        return None
    return 100.0 * flops / (tr.window_s * PEAK_OPS["bf16"])


def attention_roofline_pct(facts: Dict[str, Any]) -> Optional[float]:
    """The attention calls' least time over the attention kernels' summed
    device time in the trace."""
    tr = facts.get("trace")
    if tr is None or "attention_kernels" not in facts:
        return None
    return roofline_pct(facts["attention_least_s"], tr.kernel_seconds(facts["attention_kernels"]))
