"""The architecture-neutral part of the work a ColVLM batch needs: a page's
layout and the least time of attention calls. Each architecture's module
(``bench_port/arch/<model_type>.py``) counts a forward's model FLOPs (2 x
the matmul parameters a token passes, per token, plus attention's allowed
pairs) and its attention calls from these layouts. The yardstick of
``mfu.*`` and ``*_roofline``; tested on the CPU against hand counts
(``tests/test_arithmetic.py``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from bench_port.lib.peaks import attention_work, least_seconds


def segment_lengths(segments: np.ndarray) -> List[int]:
    """Sizes of the segments of one sequence's valid tokens."""
    return np.unique(np.asarray(segments), return_counts=True)[1].tolist()


def page_layout(page: Dict) -> Dict:
    """What a processed page (the reference processor's dict) puts through
    the model: valid patches, window (or tile) segment sizes, image tokens
    and text tokens."""
    n_text = page["n_image_tokens"] + page["n_prompt"]
    return {"patches": int(page["patches"].shape[0]),
            "segments": segment_lengths(page["segments"]),
            "image_tokens": int(page["n_image_tokens"]), "text": int(n_text)}


def attention_least_s(calls, forwards: int, backward: bool) -> float:
    """Least seconds of these calls: ``forwards`` forward passes each (2
    under remat, which recomputes the forward in the backward) and one
    backward when ``backward``."""
    total = 0.0
    for pairs, h, hkv, dh, rows in calls:
        total += forwards * least_seconds(*attention_work(pairs, h, hkv, dh, rows))
        if backward:
            total += least_seconds(*attention_work(pairs, h, hkv, dh, rows, backward=True))
    return total


def window_work(arch, cfg: Dict, forwards, passes: int, backward: bool) -> Dict[str, float]:
    """A window's ``model_flops`` (the backward, where there is one, twice
    the forward) and ``attention_least_s`` over its forwards, each (page
    layouts, query lengths), counted by the architecture's module ``arch``;
    ``passes`` forward passes a layer (2 under remat)."""
    flops = least = 0.0
    for pages, query_lengths in forwards:
        flops += arch.forward_flops(cfg, pages, query_lengths)
        least += attention_least_s(arch.attention_calls(cfg, pages, query_lengths),
                                   forwards=passes, backward=backward)
    return {"model_flops": 3.0 * flops if backward else flops, "attention_least_s": least}
