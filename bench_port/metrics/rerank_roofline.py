"""``rerank_roofline``: the exact rerank's least time (each distinct
candidate doc's rows read once, the queries, candidates and scores; 2 * dim
operations a valid (query row, doc row) pair; bf16 peak) over the summed
device time of the rerank kernels (K2, K3, K4) in the trace."""

from bench_port.lib.readers import least, roofline_pct

KERNELS = ("rerank_kernel", "dedup_kernel", "sweep_kernel")


def read(facts):
    work, tr = facts.get("work"), facts.get("trace")
    if not work or tr is None:
        return None
    return roofline_pct(sum(least(rb, ro) for rb, ro, _, _ in work),
                        tr.kernel_seconds(KERNELS))
