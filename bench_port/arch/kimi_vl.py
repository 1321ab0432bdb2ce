"""Kimi-VL (Kimi-VL-A3B-Instruct under ColQwen's retrieval head): MoonViT (a
LayerNorm ViT over native-resolution pages with a learned position table
interpolated to each grid and a 2-D rotary), the 2 x 2 merge and projector,
and a DeepSeek-V3 decoder: multi-head latent attention in every layer, the
first layer's MLP dense and the others' sigmoid-routed experts beside shared
ones. The file keeps the text sizes at its top level under the published
names and MoonViT's under ``vision_config`` (``arch/__init__.py`` says what
this module provides). Besides the contract, :func:`moe_work` counts the
routed layers' work for ``moe_roofline.kimivl``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Sequence, Tuple

from bench_port.arch import _colvlm
from bench_port.lib.peaks import allowed_pair_count
from bench_port.lib.weights import Leaf

BACKEND = "kimivl"


def sizes(cfg: Dict) -> Dict:
    v = cfg["vision_config"]
    mh, mw = v["merge_kernel_size"]
    return dict(
        v_hidden=v["hidden_size"], v_layers=v["num_hidden_layers"],
        v_heads=v["num_attention_heads"], v_mlp=v["intermediate_size"],
        pos=(v["init_pos_emb_height"], v["init_pos_emb_width"]), patch=3 * v["patch_size"] ** 2,
        merge=mh * mw, t_hidden=cfg["hidden_size"], t_layers=cfg["num_hidden_layers"],
        t_heads=cfg["num_attention_heads"], t_mlp=cfg["intermediate_size"],
        rank=cfg["kv_lora_rank"], nope=cfg["qk_nope_head_dim"], rope=cfg["qk_rope_head_dim"],
        v_dim=cfg["v_head_dim"], experts=cfg["n_routed_experts"],
        top_k=cfg["num_experts_per_tok"], shared=cfg["n_shared_experts"],
        e_mlp=cfg["moe_intermediate_size"], dense=cfg["first_k_dense_replace"],
        vocab=cfg["vocab_size"], embed=cfg["embedding_dim"])


def leaves(cfg: Dict) -> List[Leaf]:
    s = sizes(cfg)
    vh, th, h = s["v_hidden"], s["t_hidden"], s["t_heads"]
    out = _colvlm.Table()
    out.lin("vision.patch_embed", s["patch"], vh, bias=True)
    out.append(Leaf("vision.pos_embed", (*s["pos"], vh), "table"))
    for i in range(s["v_layers"]):
        b = f"vision.blocks.{i}"
        out.norm(f"{b}.ln1", vh, layer_norm=True)
        for m in ("q", "k", "v", "o"):
            out.lin(f"{b}.attn.{m}", vh, vh, bias=True)
        out.norm(f"{b}.ln2", vh, layer_norm=True)
        out.lin(f"{b}.fc1", vh, s["v_mlp"], bias=True)
        out.lin(f"{b}.fc2", s["v_mlp"], vh, bias=True)
    out.norm("vision.post_ln", vh, layer_norm=True)
    m = s["merge"]
    out.norm("merger.ln_q", vh, layer_norm=True)
    out.lin("merger.fc1", m * vh, m * vh, bias=True)
    out.lin("merger.fc2", m * vh, th, bias=True)
    out.append(Leaf("tok_embed.weight", (s["vocab"], th), "table"))
    for i in range(s["t_layers"]):
        b = f"layers.{i}"
        out.norm(f"{b}.ln1", th, layer_norm=False)
        out.lin(f"{b}.attn.q", th, h * (s["nope"] + s["rope"]), bias=False)
        out.lin(f"{b}.attn.kv_a", th, s["rank"] + s["rope"], bias=False)
        out.norm(f"{b}.attn.kv_norm", s["rank"], layer_norm=False)
        out.lin(f"{b}.attn.kv_b", s["rank"], h * (s["nope"] + s["v_dim"]), bias=False)
        out.lin(f"{b}.attn.o", h * s["v_dim"], th, bias=False)
        out.norm(f"{b}.ln2", th, layer_norm=False)
        if i < s["dense"]:
            for name, n_in, n_out in (("gate", th, s["t_mlp"]), ("up", th, s["t_mlp"]),
                                      ("down", s["t_mlp"], th)):
                out.lin(f"{b}.mlp.{name}", n_in, n_out, bias=False)
            continue
        out.append(Leaf(f"{b}.mlp.router.weight", (s["experts"], th), "matrix"))
        out.append(Leaf(f"{b}.mlp.router.bias", (s["experts"],), "bias"))
        e, w = s["experts"], s["e_mlp"]
        for name, shape in (("gate", (e, w, th)), ("up", (e, w, th)), ("down", (e, th, w))):
            out.append(Leaf(f"{b}.mlp.experts.{name}.weight", shape, "matrix"))
        sw = s["shared"] * w
        for name, n_in, n_out in (("gate", th, sw), ("up", th, sw), ("down", sw, th)):
            out.lin(f"{b}.mlp.shared.{name}", n_in, n_out, bias=False)
    out.norm("final_norm", th, layer_norm=False)
    out.lin("proj", th, s["embed"], bias=True)
    return out


def program_config(cfg: Dict, remat: bool = False):
    """The port's ``kimi_vl_a3b`` preset with every size set from the file."""
    from visual_rag_tpu_torch.models.colvlm import ColVLMConfig, MLAConfig, RoutedMoEConfig

    s = sizes(cfg)
    v = cfg["vision_config"]
    base = getattr(ColVLMConfig, cfg["preset"])()
    if s["pos"][0] != s["pos"][1]:
        raise ValueError(f"{cfg['name']}: the port's MoonViT takes a square position table")
    vision = dataclasses.replace(
        base.vision, hidden=s["v_hidden"], layers=s["v_layers"], heads=s["v_heads"],
        mlp_ratio=s["v_mlp"] / s["v_hidden"], patch_pixels=s["patch"],
        max_patches=cfg["in_token_limit"], moonvit_pos_grid=s["pos"][0],
        rope_theta=float(v["rope_theta"]), norm_eps=v["layer_norm_eps"])
    text = dataclasses.replace(
        base.text, hidden=s["t_hidden"], layers=s["t_layers"], heads=s["t_heads"],
        kv_heads=cfg["num_key_value_heads"], mlp_hidden=s["t_mlp"], vocab=s["vocab"],
        rope_theta=float(cfg["rope_theta"]), rms_eps=cfg["rms_norm_eps"],
        mla=MLAConfig(kv_lora_rank=s["rank"], qk_nope_dim=s["nope"], qk_rope_dim=s["rope"],
                      v_dim=s["v_dim"]),
        routed_moe=RoutedMoEConfig(
            experts=s["experts"], top_k=s["top_k"], expert_hidden=s["e_mlp"],
            shared_hidden=s["shared"] * s["e_mlp"], first_dense=s["dense"],
            scaling=cfg["routed_scaling_factor"], norm_topk=cfg["norm_topk_prob"]))
    out = dataclasses.replace(base, vision=vision, text=text,
                              spatial_merge=v["merge_kernel_size"][0],
                              image_token_id=cfg["media_placeholder_token_id"],
                              embed_dim=cfg["embedding_dim"], dtype=cfg["torch_dtype"],
                              remat=remat)
    if int(out.vision.hidden * out.vision.mlp_ratio) != s["v_mlp"]:
        raise ValueError(f"{cfg['name']}: mlp_ratio does not give {s['v_mlp']}")
    return out


def vocab(cfg: Dict) -> int:
    return cfg["vocab_size"]


def _text_layer_params(s: Dict, moe: bool) -> int:
    """Matmul parameters a token passes in one decoder layer: latent
    attention's projections, then the dense MLP, or the router and the
    ``top_k`` routed and the shared experts it runs."""
    th, h = s["t_hidden"], s["t_heads"]
    attn = (th * h * (s["nope"] + s["rope"]) + th * (s["rank"] + s["rope"])
            + s["rank"] * h * (s["nope"] + s["v_dim"]) + h * s["v_dim"] * th)
    if not moe:
        return attn + 3 * th * s["t_mlp"]
    return attn + th * s["experts"] + (s["top_k"] + s["shared"]) * 3 * th * s["e_mlp"]


def forward_flops(cfg: Dict, pages: Sequence[Dict], query_lengths: Sequence[int]) -> float:
    """Model FLOPs of one forward: 2 x the matmul parameters a token passes
    (only the experts it runs), plus MoonViT's 4 x 72 x 16 per allowed pair
    a layer and latent attention's 2 x (192 + 128) x 16 per causal pair."""
    s = sizes(cfg)
    vh, m = s["v_hidden"], s["merge"]
    vit_layer = 4 * vh * vh + 2 * vh * s["v_mlp"]
    connector = (m * vh) ** 2 + m * vh * s["t_hidden"]  # per merged token
    layers = [_text_layer_params(s, i >= s["dense"]) for i in range(s["t_layers"])]
    per_token = sum(layers) + s["t_hidden"] * s["embed"]
    pair = 2 * (s["nope"] + s["rope"] + s["v_dim"]) * s["t_heads"]
    flops = 0.0
    for pg in pages:
        n = pg["patches"]
        flops += 2.0 * n * (s["patch"] * vh + s["v_layers"] * vit_layer)
        flops += 2.0 * pg["image_tokens"] * connector
        flops += 4.0 * vh * s["v_layers"] * allowed_pair_count(pg["segments"], causal=False)
    for t in [pg["text"] for pg in pages] + list(query_lengths):
        flops += 2.0 * t * per_token + pair * s["t_layers"] * allowed_pair_count([t], True)
    return flops


def attention_calls(cfg: Dict, pages: Sequence[Dict], query_lengths: Sequence[int]
                    ) -> List[Tuple[int, int, int, int, int]]:
    """One forward's attention calls (allowed pairs, heads, kv heads, dh,
    valid rows), one a layer of each tower. Latent attention is given dh
    160: its q.k over 192 and p.v over 128 make 4 x 160 flops a pair and
    head, and its q, k, v and output rows 192 + 192 + 128 + 128 = 4 x 160
    elements, as ``lib.peaks.attention_work`` counts a call of dh 160."""
    s = sizes(cfg)
    rows_v = sum(pg["patches"] for pg in pages)
    whole = sum(allowed_pair_count(pg["segments"], False) for pg in pages)
    calls = [(whole, s["v_heads"], s["v_heads"], s["v_hidden"] // s["v_heads"], rows_v)]
    calls *= s["v_layers"]
    dh = (2 * (s["nope"] + s["rope"]) + 2 * s["v_dim"]) // 4
    for lengths in ([pg["text"] for pg in pages], list(query_lengths)):
        if lengths:
            pairs = allowed_pair_count(lengths, True)
            calls += [(pairs, s["t_heads"], s["t_heads"], dh, sum(lengths))] * s["t_layers"]
    return calls


def moe_work(cfg: Dict, pages: Sequence[Dict], query_lengths: Sequence[int]
             ) -> Tuple[float, float]:
    """(bytes, FLOPs) of one forward's routed layers, each over the batch's
    valid text tokens T: the router, the ``top_k`` routed and the shared
    experts' SwiGLUs (2 x 3 x hidden x width each a token); the bf16 weights
    of every expert the tokens can reach (min(experts, T x top_k)) and of
    the shared ones, the f32 router, and x read and the output written once
    in bf16."""
    s = sizes(cfg)
    th, w = s["t_hidden"], s["e_mlp"]
    t = sum(pg["text"] for pg in pages) + sum(query_lengths)
    layers = s["t_layers"] - s["dense"]
    flops = 2.0 * t * (th * s["experts"] + (s["top_k"] + s["shared"]) * 3 * th * w)
    hit = min(s["experts"], t * s["top_k"]) + s["shared"]
    nbytes = hit * 3 * th * w * 2 + s["experts"] * th * 4 + 2 * t * th * 2
    return float(layers * nbytes), float(layers * flops)


def tiny(cfg: Dict) -> Dict:
    """Every width cut (MoonViT at its head dim 72, latent attention at a
    rank of 32); the vocabulary kept, since the media markers sit at its top."""
    out = copy.deepcopy(cfg)
    out.update(hidden_size=128, intermediate_size=192, moe_intermediate_size=32,
               num_hidden_layers=3, num_attention_heads=2, num_key_value_heads=2,
               n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=2,
               kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
               in_token_limit=256)
    out["vision_config"] = dict(out["vision_config"], hidden_size=144, intermediate_size=288,
                                num_hidden_layers=2, num_attention_heads=2,
                                init_pos_emb_height=8, init_pos_emb_width=8)
    return out
