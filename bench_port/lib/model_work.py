"""The work a ColVLM batch needs, from the configuration file and the
batch's layout: model FLOPs (2 x the matmul parameters a token passes, per
token, plus attention's allowed pairs) and each attention call's bytes and
operations. The yardstick of ``mfu.*`` and ``*_roofline``; tested on the
CPU against hand counts (``tests/test_arithmetic.py``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from bench_port.lib.peaks import allowed_pair_count, attention_work, least_seconds
from bench_port.lib.weights import sizes


def segment_lengths(segments: np.ndarray) -> List[int]:
    """Sizes of the segments of one sequence's valid tokens."""
    return np.unique(np.asarray(segments), return_counts=True)[1].tolist()


def page_layout(cfg: Dict, page: Dict) -> Dict:
    """What a processed page (the reference processor's dict) puts through
    the model: valid patches, window (or tile) segment sizes, image tokens
    and text tokens."""
    n_text = page["n_image_tokens"] + page["n_prompt"]
    return {"patches": int(page["patches"].shape[0]),
            "segments": segment_lengths(page["segments"]),
            "image_tokens": int(page["n_image_tokens"]), "text": int(n_text)}


def vision_layers(cfg: Dict) -> Tuple[int, List[int]]:
    if cfg["model_type"] == "qwen2_5_vl":
        v = cfg["vision_config"]
        return v["depth"], list(v["fullatt_block_indexes"])
    return cfg["vision_config"]["num_hidden_layers"], []


def forward_flops(cfg: Dict, pages: Sequence[Dict], query_lengths: Sequence[int]) -> float:
    """Model FLOPs of one forward over these pages (``page_layout`` dicts)
    and queries: 2 x matmul parameters x tokens, plus 4 x dh x heads per
    allowed attention pair."""
    s = sizes(cfg)
    vh, th = s["v_hidden"], s["t_hidden"]
    dh_t = th // s["t_heads"]
    text_layer = (2 * th * th + 2 * th * s["t_kv"] * dh_t) + 3 * th * s["t_mlp"]
    if s["kind"] == "qwen":
        vit_layer = 4 * vh * vh + 3 * vh * s["v_mlp"]
        m2 = s["merge"] ** 2
        connector = (m2 * vh) ** 2 + m2 * vh * th  # per merged token
    else:
        vit_layer = 4 * vh * vh + 2 * vh * s["v_mlp"]
        connector = vh * s["shuffle"] ** 2 * th  # per image token
    n_layers, full = vision_layers(cfg)
    flops = 0.0
    for pg in pages:
        n = pg["patches"]
        flops += 2.0 * n * (s["patch"] * vh + n_layers * vit_layer)
        flops += 2.0 * pg["image_tokens"] * connector
        win = allowed_pair_count(pg["segments"], causal=False)
        whole = allowed_pair_count([n], causal=False)
        pairs = sum(whole if i in full else win for i in range(n_layers))
        flops += 4.0 * (vh // s["v_heads"]) * s["v_heads"] * pairs
    texts = [pg["text"] for pg in pages] + list(query_lengths)
    for t in texts:
        flops += 2.0 * t * (s["t_layers"] * text_layer + th * s["embed"])
        flops += 4.0 * dh_t * s["t_heads"] * s["t_layers"] * allowed_pair_count([t], True)
    return flops


def attention_calls(cfg: Dict, pages: Sequence[Dict], query_lengths: Sequence[int]
                    ) -> List[Tuple[int, int, int, int, int]]:
    """One forward's attention calls over the batch: (allowed pairs, heads,
    kv heads, dh, valid rows), one per layer of each tower (a call covers
    the whole batch)."""
    s = sizes(cfg)
    n_layers, full = vision_layers(cfg)
    vh, th = s["v_hidden"], s["t_hidden"]
    rows_v = sum(pg["patches"] for pg in pages)
    win = sum(allowed_pair_count(pg["segments"], False) for pg in pages)
    whole = sum(allowed_pair_count([pg["patches"]], False) for pg in pages)
    calls = [((whole if i in full else win), s["v_heads"], s["v_heads"],
              vh // s["v_heads"], rows_v) for i in range(n_layers)]
    dh = th // s["t_heads"]
    for lengths in ([pg["text"] for pg in pages], list(query_lengths)):
        if lengths:
            pairs = allowed_pair_count(lengths, True)
            calls += [(pairs, s["t_heads"], s["t_kv"], dh, sum(lengths))] * s["t_layers"]
    return calls


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
