"""``ingest_k10_roofline``: K10's serving forward over the window's page
batches: the calls' least time (q, k, v and out once, 4 x dh operations a
head and allowed pair; pairs within each tile and the causal page text)
over the summed device time of K10 in the trace."""

from bench_port.lib.readers import attention_roofline_pct


def read(facts):
    return attention_roofline_pct(facts)
