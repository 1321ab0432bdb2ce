"""``stage1_roofline``: the pooled stage-1 over the window's batches: its
least time (the pooled store read once, 2 * dim operations a query and
valid pooled row; the stage-1 half of ``mfu.search``'s yardstick) over the
summed device time of the program's ``search.stage1`` spans (the stream's
time between each span's two events)."""

from bench_port.lib.readers import least, roofline_pct
from bench_port.lib.spans import device_ms, window_spans


def read(facts):
    work, tr = facts.get("work"), facts.get("trace")
    if not work or tr is None:
        return None
    spans = window_spans(tr, "search.stage1")
    if not spans:
        return None
    return roofline_pct(sum(least(sb, so) for _, _, sb, so in work), device_ms(spans) / 1e3)
