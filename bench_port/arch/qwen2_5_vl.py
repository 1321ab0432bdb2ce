"""Qwen2.5-VL (ColQwen2.5): a window-attention vision tower of RMSNorm blocks
with a gated MLP and no patch bias, full layers at ``fullatt_block_indexes``,
the 2 x 2 patch merger, and the Qwen2.5 decoder (q/k/v biases, M-RoPE). The
file keeps the text sizes at its top level (``arch/__init__.py`` says what
this module provides)."""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence, Tuple

from bench_port.arch import _colvlm
from bench_port.lib.weights import Leaf

BACKEND = "colqwen2.5"


def sizes(cfg: Dict) -> Dict:
    v = cfg["vision_config"]
    return dict(
        v_hidden=v["hidden_size"], v_layers=v["depth"], v_heads=v["num_heads"],
        v_mlp=v["intermediate_size"], full=list(v["fullatt_block_indexes"]),
        patch=3 * v["patch_size"] ** 2, merge=v["spatial_merge_size"],
        t_hidden=cfg["hidden_size"], t_layers=cfg["num_hidden_layers"],
        t_heads=cfg["num_attention_heads"], t_kv=cfg["num_key_value_heads"],
        t_mlp=cfg["intermediate_size"], vocab=cfg["vocab_size"], embed=cfg["embedding_dim"])


def leaves(cfg: Dict) -> List[Leaf]:
    s = sizes(cfg)
    vh, th = s["v_hidden"], s["t_hidden"]
    out = _colvlm.Table()
    out.lin("vision.patch_embed", s["patch"], vh, bias=False)
    for i in range(s["v_layers"]):
        b = f"vision.blocks.{i}"
        out.norm(f"{b}.ln1", vh, layer_norm=False)
        for m in ("q", "k", "v", "o"):
            out.lin(f"{b}.attn.{m}", vh, vh, bias=True)
        out.norm(f"{b}.ln2", vh, layer_norm=False)
        out.lin(f"{b}.mlp.gate", vh, s["v_mlp"], True)
        out.lin(f"{b}.mlp.up", vh, s["v_mlp"], True)
        out.lin(f"{b}.mlp.down", s["v_mlp"], vh, True)
    m2 = s["merge"] ** 2
    out.norm("merger.ln_q", vh, layer_norm=False)
    out.lin("merger.fc1", m2 * vh, m2 * vh, True)
    out.lin("merger.fc2", m2 * vh, th, True)
    return _colvlm.text_leaves(out, s, qkv_bias=True)


def program_config(cfg: Dict, remat: bool = False):
    """The preset's sizes equal the file's but the vision MLP (the file's
    3420, the preset's 5120)."""
    v = cfg["vision_config"]
    merge = v["spatial_merge_size"]
    vision = dict(hidden=v["hidden_size"], layers=v["depth"], heads=v["num_heads"],
                  mlp_ratio=v["intermediate_size"] / v["hidden_size"],
                  patch_pixels=3 * v["patch_size"] ** 2,
                  max_patches=cfg["max_visual_tokens"] * merge * merge,
                  window_side=v["window_size"] // v["patch_size"],
                  full_attn_layers=tuple(v["fullatt_block_indexes"]))
    return _colvlm.program_config(cfg, cfg, vision, merge, remat,
                                  mrope_section=tuple(cfg["rope_scaling"]["mrope_section"]))


def vocab(cfg: Dict) -> int:
    return cfg["vocab_size"]


def forward_flops(cfg: Dict, pages: Sequence[Dict], query_lengths: Sequence[int]) -> float:
    s = sizes(cfg)
    vh, m2 = s["v_hidden"], s["merge"] ** 2
    return _colvlm.forward_flops(
        s, vit_layer=4 * vh * vh + 3 * vh * s["v_mlp"],
        connector=(m2 * vh) ** 2 + m2 * vh * s["t_hidden"],  # per merged token
        pages=pages, query_lengths=query_lengths)


def attention_calls(cfg: Dict, pages: Sequence[Dict], query_lengths: Sequence[int]
                    ) -> List[Tuple[int, int, int, int, int]]:
    return _colvlm.attention_calls(sizes(cfg), pages, query_lengths)


def tiny(cfg: Dict) -> Dict:
    out = copy.deepcopy(cfg)
    out.update(hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, vocab_size=1000, image_token_id=999, max_visual_tokens=64,
               rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]})
    out["vision_config"] = dict(out["vision_config"], depth=3, hidden_size=32,
                                intermediate_size=48, num_heads=2, fullatt_block_indexes=[1],
                                out_hidden_size=64)
    return out
