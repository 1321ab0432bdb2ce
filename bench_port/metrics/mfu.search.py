"""``mfu.search``: the whole search's share of the card's peak. A batch is
not a model step, so this is its roofline share: the least time of every
batch's pooled stage-1 (the pooled store read once, 2 * dim operations a
query and valid pooled row) and exact rerank (as ``rerank_roofline``),
summed over the window's batches, over the traced window's seconds."""

from bench_port.lib.readers import least


def read(facts):
    work, tr = facts.get("work"), facts.get("trace")
    if not work or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * sum(least(rb, ro) + least(sb, so) for rb, ro, sb, so in work) / tr.window_s
