"""What the dense ColVLM architectures share: a vision tower of transformer
blocks, a connector into a decoder of grouped-query attention and a gated
MLP, and the projection to the embedding. Each function takes the dict of
its architecture's ``sizes(cfg)``: ``v_hidden``, ``v_layers``, ``v_heads``,
``full`` (the vision layers that attend over the whole page), ``patch``,
``t_hidden``, ``t_layers``, ``t_heads``, ``t_kv``, ``t_mlp``, ``vocab``,
``embed``."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from bench_port.lib.peaks import allowed_pair_count
from bench_port.lib.weights import Leaf


class Table(list):
    """A leaf table being built, in the flat buffer's order."""

    def lin(self, name: str, n_in: int, n_out: int, bias: bool) -> None:
        self.append(Leaf(f"{name}.weight", (n_out, n_in), "matrix"))
        if bias:
            self.append(Leaf(f"{name}.bias", (n_out,), "bias"))

    def norm(self, name: str, dim: int, layer_norm: bool) -> None:
        self.append(Leaf(f"{name}.scale", (dim,), "scale"))
        if layer_norm:
            self.append(Leaf(f"{name}.bias", (dim,), "ln_bias"))


def text_leaves(out: Table, s: Dict, qkv_bias: bool) -> List[Leaf]:
    """The token table, the decoder layers, the final norm and the projection."""
    th = s["t_hidden"]
    out.append(Leaf("tok_embed.weight", (s["vocab"], th), "table"))
    dh = th // s["t_heads"]
    for i in range(s["t_layers"]):
        b = f"layers.{i}"
        out.norm(f"{b}.ln1", th, layer_norm=False)
        out.lin(f"{b}.attn.q", th, s["t_heads"] * dh, bias=qkv_bias)
        out.lin(f"{b}.attn.k", th, s["t_kv"] * dh, bias=qkv_bias)
        out.lin(f"{b}.attn.v", th, s["t_kv"] * dh, bias=qkv_bias)
        out.lin(f"{b}.attn.o", s["t_heads"] * dh, th, bias=False)
        out.norm(f"{b}.ln2", th, layer_norm=False)
        out.lin(f"{b}.mlp.gate", th, s["t_mlp"], False)
        out.lin(f"{b}.mlp.up", th, s["t_mlp"], False)
        out.lin(f"{b}.mlp.down", s["t_mlp"], th, False)
    out.norm("final_norm", th, layer_norm=False)
    out.lin("proj", th, s["embed"], bias=True)
    return out


def forward_flops(s: Dict, vit_layer: int, connector: int, pages: Sequence[Dict],
                  query_lengths: Sequence[int]) -> float:
    """Model FLOPs of one forward over these pages (``page_layout`` dicts) and
    queries: 2 x matmul parameters x tokens, plus 4 x dh x heads per allowed
    attention pair. ``vit_layer``: a vision block's matmul parameters;
    ``connector``: the connector's, per image token."""
    vh, th = s["v_hidden"], s["t_hidden"]
    dh_t = th // s["t_heads"]
    text_layer = (2 * th * th + 2 * th * s["t_kv"] * dh_t) + 3 * th * s["t_mlp"]
    n_layers, full = s["v_layers"], s["full"]
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


def attention_calls(s: Dict, pages: Sequence[Dict], query_lengths: Sequence[int]
                    ) -> List[Tuple[int, int, int, int, int]]:
    """One forward's attention calls over the batch: (allowed pairs, heads,
    kv heads, dh, valid rows), one per layer of each tower (a call covers
    the whole batch)."""
    n_layers, full = s["v_layers"], s["full"]
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


def program_config(cfg: Dict, text: Dict, vision_sizes: Dict, merge: int, remat: bool,
                   **text_extra):
    """The port's preset that ``cfg`` names (its layer kinds: norms, biases,
    rotary, merge or shuffle) with every size set from the file: the vision
    tower's from ``vision_sizes``, the decoder's from ``text`` (the file's
    text section)."""
    from visual_rag_tpu_torch.models.colvlm import ColVLMConfig

    base = getattr(ColVLMConfig, cfg["preset"])()
    vision = dataclasses.replace(base.vision, **vision_sizes)
    text_cfg = dataclasses.replace(
        base.text, hidden=text["hidden_size"], layers=text["num_hidden_layers"],
        heads=text["num_attention_heads"], kv_heads=text["num_key_value_heads"],
        mlp_hidden=text["intermediate_size"], vocab=text["vocab_size"],
        rope_theta=text["rope_theta"], **text_extra)
    out = dataclasses.replace(base, vision=vision, text=text_cfg, spatial_merge=merge,
                              image_token_id=cfg["image_token_id"],
                              embed_dim=cfg["embedding_dim"], dtype=cfg["torch_dtype"],
                              remat=remat)
    mlp = cfg["vision_config"]["intermediate_size"]
    if int(out.vision.hidden * out.vision.mlp_ratio) != mlp:
        raise ValueError(f"{cfg['name']}: mlp_ratio does not give {mlp}")
    return out
