"""``train_attention_roofline``: K10's lse forward (twice a layer under
remat), B4 and B5 over the window's steps: the calls' least time (q, k, v,
out read or written once, 4 x dh operations a head and allowed pair forward,
10 x dh backward; pairs from each batch's own windows, pages and causal
text) over the summed device time of those kernels in the trace."""

from bench_port.lib.readers import attention_roofline_pct


def read(facts):
    return attention_roofline_pct(facts)
