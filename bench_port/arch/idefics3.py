"""Idefics3 (ColSmol): SigLIP tiles (LayerNorm blocks with a two-matrix MLP,
learned positions, a final LayerNorm), the pixel shuffle into the connector,
and a Llama decoder (SmolLM2). The file keeps the text sizes under
``text_config`` (``arch/__init__.py`` says what this module provides)."""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence, Tuple

from bench_port.arch import _colvlm
from bench_port.lib.weights import Leaf

BACKEND = "colsmol"


def sizes(cfg: Dict) -> Dict:
    v, t = cfg["vision_config"], cfg["text_config"]
    return dict(
        v_hidden=v["hidden_size"], v_layers=v["num_hidden_layers"],
        v_heads=v["num_attention_heads"], v_mlp=v["intermediate_size"], full=[],
        patch=3 * v["patch_size"] ** 2, shuffle=cfg["scale_factor"],
        tile_patches=(v["image_size"] // v["patch_size"]) ** 2,
        t_hidden=t["hidden_size"], t_layers=t["num_hidden_layers"],
        t_heads=t["num_attention_heads"], t_kv=t["num_key_value_heads"],
        t_mlp=t["intermediate_size"], vocab=t["vocab_size"], embed=cfg["embedding_dim"])


def leaves(cfg: Dict) -> List[Leaf]:
    s = sizes(cfg)
    vh, th = s["v_hidden"], s["t_hidden"]
    out = _colvlm.Table()
    out.lin("vision.patch_embed", s["patch"], vh, bias=True)
    out.append(Leaf("vision.pos_embed", (s["tile_patches"], vh), "table"))
    for i in range(s["v_layers"]):
        b = f"vision.blocks.{i}"
        out.norm(f"{b}.ln1", vh, layer_norm=True)
        for m in ("q", "k", "v", "o"):
            out.lin(f"{b}.attn.{m}", vh, vh, bias=True)
        out.norm(f"{b}.ln2", vh, layer_norm=True)
        out.lin(f"{b}.fc1", vh, s["v_mlp"], True)
        out.lin(f"{b}.fc2", s["v_mlp"], vh, True)
    out.norm("vision.post_ln", vh, layer_norm=True)
    out.lin("connector", vh * s["shuffle"] ** 2, th, bias=False)
    return _colvlm.text_leaves(out, s, qkv_bias=False)


def program_config(cfg: Dict, remat: bool = False):
    v = cfg["vision_config"]
    vision = dict(hidden=v["hidden_size"], layers=v["num_hidden_layers"],
                  heads=v["num_attention_heads"],
                  mlp_ratio=v["intermediate_size"] / v["hidden_size"],
                  patch_pixels=3 * v["patch_size"] ** 2, pixel_shuffle=cfg["scale_factor"])
    return _colvlm.program_config(cfg, cfg["text_config"], vision, 1, remat)


def vocab(cfg: Dict) -> int:
    return cfg["text_config"]["vocab_size"]


def forward_flops(cfg: Dict, pages: Sequence[Dict], query_lengths: Sequence[int]) -> float:
    s = sizes(cfg)
    vh = s["v_hidden"]
    return _colvlm.forward_flops(
        s, vit_layer=4 * vh * vh + 2 * vh * s["v_mlp"],
        connector=vh * s["shuffle"] ** 2 * s["t_hidden"],  # per image token
        pages=pages, query_lengths=query_lengths)


def attention_calls(cfg: Dict, pages: Sequence[Dict], query_lengths: Sequence[int]
                    ) -> List[Tuple[int, int, int, int, int]]:
    return _colvlm.attention_calls(sizes(cfg), pages, query_lengths)


def tiny(cfg: Dict) -> Dict:
    out = copy.deepcopy(cfg)
    out["text_config"] = dict(out["text_config"], hidden_size=64, intermediate_size=96,
                              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                              vocab_size=1000)
    out["vision_config"] = dict(out["vision_config"], hidden_size=32, intermediate_size=64,
                                num_hidden_layers=2, num_attention_heads=2)
    out["image_token_id"] = 999
    return out
