"""``moe_roofline.kimivl``: the routed layers over the window's page batches:
their least time (``arch.moe_work``: the router's, the chosen routed and the
shared experts' FLOPs of the valid text tokens at the bf16 peak, against the
bytes of the expert weights those tokens can reach and of their activations
in and out) over the summed device time of the program's ``moe.experts``
spans (the stream's time between each span's two events: the router, the
layout, K11 and the shared experts of one layer). A batch's padded text
rows go through the routed layers too, and are not counted: the share is of
the work the pages need."""

from bench_port.lib.readers import least, roofline_pct
from bench_port.lib.spans import device_ms, window_spans


def read(facts):
    tr, arch = facts.get("trace"), facts.get("arch")
    if tr is None or "forwards" not in facts or not hasattr(arch, "moe_work"):
        return None
    spans = window_spans(tr, "moe.experts")
    if not spans:
        return None
    least_s = sum(least(*arch.moe_work(facts["config"], pages, queries))
                  for pages, queries in facts["forwards"])
    return roofline_pct(least_s, device_ms(spans) / 1e3)
