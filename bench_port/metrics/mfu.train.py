"""``mfu.train``: model FLOPs of the window's steps (2 x matmul parameters
x tokens, plus 4 x dh x heads per allowed attention pair; the backward
twice the forward, remat's recompute no work) over the window's seconds x
the bf16 peak (``lib/model_work.py``)."""

from bench_port.lib.readers import mfu_pct


def read(facts):
    return mfu_pct(facts)
