"""A ColVLM's parameters from a configuration file and a seed, drawn on the
card in a few large calls.

The table of leaves (name, shape, how it is scaled) is the harness's own,
made from the configuration's published sizes; :func:`check_names` holds
it against the program's module tree, so the two cannot drift apart
silently. The values are one flat f32 buffer of standard normals drawn in
chunks of ``CHUNK`` by a ``torch.Generator`` on the device, each leaf a
slice of it scaled in place: a matrix by ``1 / sqrt(fan_in)``, a table by
0.02, a bias by 0.02, a norm's scale ``1 + 0.1 z`` and a LayerNorm's bias
``0.02 z`` (biases and scales that are not 0 and 1, so the comparison
covers them). The reference draws the same buffer again from the seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import torch

CHUNK = 1 << 26  # elements a draw: 256 MB of f32


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    kind: str  # "matrix" | "table" | "bias" | "scale" | "ln_bias"

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def sizes(cfg: Dict) -> Dict:
    """The sizes the table needs, from either configuration file's layout."""
    if cfg["model_type"] == "qwen2_5_vl":
        v = cfg["vision_config"]
        return dict(
            kind="qwen", v_hidden=v["hidden_size"], v_layers=v["depth"], v_heads=v["num_heads"],
            v_mlp=v["intermediate_size"], patch=3 * v["patch_size"] ** 2,
            merge=v["spatial_merge_size"], t_hidden=cfg["hidden_size"],
            t_layers=cfg["num_hidden_layers"], t_heads=cfg["num_attention_heads"],
            t_kv=cfg["num_key_value_heads"], t_mlp=cfg["intermediate_size"],
            vocab=cfg["vocab_size"], embed=cfg["embedding_dim"])
    v, t = cfg["vision_config"], cfg["text_config"]
    return dict(
        kind="idefics3", v_hidden=v["hidden_size"], v_layers=v["num_hidden_layers"],
        v_heads=v["num_attention_heads"], v_mlp=v["intermediate_size"],
        patch=3 * v["patch_size"] ** 2, shuffle=cfg["scale_factor"],
        tile_patches=(v["image_size"] // v["patch_size"]) ** 2,
        t_hidden=t["hidden_size"], t_layers=t["num_hidden_layers"],
        t_heads=t["num_attention_heads"], t_kv=t["num_key_value_heads"],
        t_mlp=t["intermediate_size"], vocab=t["vocab_size"], embed=cfg["embedding_dim"])


def leaves(cfg: Dict) -> List[Leaf]:
    """Every parameter of the model, in the order of the flat buffer."""
    s = sizes(cfg)
    qwen = s["kind"] == "qwen"
    vh, th = s["v_hidden"], s["t_hidden"]
    out: List[Leaf] = []

    def lin(name, n_in, n_out, bias):
        out.append(Leaf(f"{name}.weight", (n_out, n_in), "matrix"))
        if bias:
            out.append(Leaf(f"{name}.bias", (n_out,), "bias"))

    def norm(name, dim, layer_norm):
        out.append(Leaf(f"{name}.scale", (dim,), "scale"))
        if layer_norm:
            out.append(Leaf(f"{name}.bias", (dim,), "ln_bias"))

    lin("vision.patch_embed", s["patch"], vh, bias=not qwen)
    if not qwen:
        out.append(Leaf("vision.pos_embed", (s["tile_patches"], vh), "table"))
    for i in range(s["v_layers"]):
        b = f"vision.blocks.{i}"
        norm(f"{b}.ln1", vh, layer_norm=not qwen)
        for m in ("q", "k", "v", "o"):
            lin(f"{b}.attn.{m}", vh, vh, bias=True)
        norm(f"{b}.ln2", vh, layer_norm=not qwen)
        if qwen:
            lin(f"{b}.mlp.gate", vh, s["v_mlp"], True)
            lin(f"{b}.mlp.up", vh, s["v_mlp"], True)
            lin(f"{b}.mlp.down", s["v_mlp"], vh, True)
        else:
            lin(f"{b}.fc1", vh, s["v_mlp"], True)
            lin(f"{b}.fc2", s["v_mlp"], vh, True)
    if qwen:
        m2 = s["merge"] ** 2
        norm("merger.ln_q", vh, layer_norm=False)
        lin("merger.fc1", m2 * vh, m2 * vh, True)
        lin("merger.fc2", m2 * vh, th, True)
    else:
        norm("vision.post_ln", vh, layer_norm=True)
        lin("connector", vh * s["shuffle"] ** 2, th, bias=False)
    out.append(Leaf("tok_embed.weight", (s["vocab"], th), "table"))
    dh = th // s["t_heads"]
    for i in range(s["t_layers"]):
        b = f"layers.{i}"
        norm(f"{b}.ln1", th, layer_norm=False)
        lin(f"{b}.attn.q", th, s["t_heads"] * dh, bias=qwen)
        lin(f"{b}.attn.k", th, s["t_kv"] * dh, bias=qwen)
        lin(f"{b}.attn.v", th, s["t_kv"] * dh, bias=qwen)
        lin(f"{b}.attn.o", s["t_heads"] * dh, th, bias=False)
        norm(f"{b}.ln2", th, layer_norm=False)
        lin(f"{b}.mlp.gate", th, s["t_mlp"], False)
        lin(f"{b}.mlp.up", th, s["t_mlp"], False)
        lin(f"{b}.mlp.down", s["t_mlp"], th, False)
    norm("final_norm", th, layer_norm=False)
    lin("proj", th, s["embed"], bias=True)
    return out


def _scale_(t: torch.Tensor, leaf: Leaf) -> None:
    if leaf.kind == "matrix":
        t.mul_(leaf.shape[-1] ** -0.5)
    elif leaf.kind == "scale":
        t.mul_(0.1).add_(1.0)
    else:  # table, bias, ln_bias
        t.mul_(0.02)


def normals(total: int, seed: int, device) -> Iterator[torch.Tensor]:
    """The flat buffer's standard normals, chunk by chunk (always the same
    chunks, so a later pass draws the same values)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for s in range(0, total, CHUNK):
        yield torch.randn((min(CHUNK, total - s),), generator=gen, device=device,
                          dtype=torch.float32)


def draw(cfg: Dict, seed: int, device) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(flat f32 buffer, {name: view of it}) of every leaf, scaled."""
    table = leaves(cfg)
    total = sum(leaf.numel for leaf in table)
    flat = torch.empty((total,), dtype=torch.float32, device=device)
    pos = 0
    for z in normals(total, seed, device):
        flat[pos:pos + z.numel()] = z
        pos += z.numel()
    params, pos = {}, 0
    for leaf in table:
        view = flat[pos:pos + leaf.numel].view(leaf.shape)
        _scale_(view, leaf)
        params[leaf.name] = view
        pos += leaf.numel
    return flat, params


def initial_norms_of_change(cfg: Dict, seed: int, params: Dict[str, torch.Tensor]
                            ) -> Dict[str, float]:
    """{leaf: ||params[leaf] - its initial value||}, the initial values drawn
    again from the seed chunk by chunk (no copy of the model is held)."""
    table = leaves(cfg)
    total = sum(leaf.numel for leaf in table)
    device = next(iter(params.values())).device
    sq = {leaf.name: torch.zeros((), dtype=torch.float64, device=device) for leaf in table}
    it = normals(total, seed, device)
    buf, buf_start = next(it), 0
    pos = 0
    for leaf in table:
        cur = params[leaf.name].detach().reshape(-1)
        done = 0
        while done < leaf.numel:
            while pos + done >= buf_start + buf.numel():
                buf_start += buf.numel()
                buf = next(it)
            a = pos + done - buf_start
            n = min(leaf.numel - done, buf.numel() - a)
            z = buf[a:a + n].clone()
            _scale_(z, leaf)
            d = cur[done:done + n].float() - z
            sq[leaf.name] += (d.double() * d.double()).sum()
            done += n
        pos += leaf.numel
    return {k: float(v.sqrt()) for k, v in sq.items()}


def check_names(params: Dict[str, torch.Tensor], model_state: Dict[str, torch.Tensor]) -> None:
    """Raise unless the table has exactly the program model's leaves and shapes."""
    want = {k: tuple(v.shape) for k, v in model_state.items()}
    have = {k: tuple(v.shape) for k, v in params.items()}
    if want != have:
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        shapes = sorted(k for k in set(want) & set(have) if want[k] != have[k])[:5]
        raise ValueError(f"weight table does not fit the model: missing {missing}, "
                         f"unexpected {extra}, other shapes {shapes}")
