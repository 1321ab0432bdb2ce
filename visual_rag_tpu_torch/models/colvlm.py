"""ColVLM in PyTorch, for the configurations ColSmol-500M runs.

Counterpart of ``visual_rag_tpu/models/colvlm.py``. The four config
dataclasses and their classmethods (``:31-177``) are copied as they are, so
that a config means the same on both sides. The modules are the ones
ColSmol runs: ``RMSNorm`` (``:233-247``), 1-D ``_rope`` (``:180-209``),
``GQAttention`` (``:250-295``), ``SwiGLU`` (``:298-312``), ``DecoderBlock``
(``:387-408``), ``ViTBlock`` (``:451-477``), ``VisionTower`` (``:480-534``),
and ``ColVLM`` with the pixel shuffle (``:604-618``), the connector, ``_lm``,
``_project`` and the image-slot merge (``:654-709``). A config that needs
more (MoE, scanned or rematerialized layers, the PatchMerger, M-RoPE or 2-D
RoPE, gated or RMS-normed vision blocks, Gemma's norm offset, embedding
scale or GeGLU) is refused with a ``NotImplementedError`` naming the field.

Numerics follow flax's: a ``Dense`` with ``dtype`` bf16 casts its input, its
kernel and its bias to bf16 (the port stores them in bf16); ``LayerNorm``
takes its statistics in f32 with the fast variance ``E[x^2] - E[x]^2`` and
epsilon 1e-6, with f32 scale and bias; ``RMSNorm`` runs in f32 with an f32
scale; RoPE angles are f32 and the result is cast back; ``gelu`` is the tanh
approximation; embeddings are tables in the model dtype.

Parameter names mirror the flax tree (``models/convert.py`` maps one onto
the other). Every module takes ``device`` and ``dtype`` at construction;
``device="meta"`` builds the shapes only, for ``load_state_dict(...,
assign=True)``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from visual_rag_tpu_torch.models.attention import mha

DEFAULT_EMBED_DIM = 128


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    patch_pixels: int = 3 * 16 * 16  # flattened patch input size
    max_patches: int = 1024
    # Qwen2.5-VL-style window attention: tokens attend within window_side x
    # window_side patch windows except at full_attn_layers (0 = full attention
    # everywhere, the SigLIP/ColPali behavior)
    window_side: int = 0
    full_attn_layers: tuple = ()
    # SmolVLM/ColSmol pixel shuffle: each tile is (8*s)^2 real patches through
    # the ViT, then s x s spatial blocks fold into channels -> 64 tokens of
    # hidden*s^2 per tile (1 = no shuffle). Tiles attend independently via the
    # processor-supplied per-tile segment ids.
    pixel_shuffle: int = 1
    # HF-checkpoint fidelity knobs (exact parametrizations of the real
    # towers; defaults keep the lean test-scale tree):
    attn_bias: bool = False  # SigLIP & Qwen-ViT attention carries q/k/v/o biases
    mlp_gated: bool = False  # Qwen2.5-VL ViT MLP is biased SwiGLU (gate/up/down)
    rms_norm: bool = False  # Qwen2.5-VL ViT norms are RMSNorm (not LayerNorm)
    patch_bias: bool = True  # Qwen2.5-VL patch embed is a bias-free Conv3d
    learned_pos: bool = True  # Qwen2.5-VL has no learned pos table (2D RoPE)
    post_ln: bool = True  # Qwen2.5-VL has no final vision LayerNorm
    rope_2d: bool = False  # Qwen2.5-VL 2D rotary over (row, col) positions
    rope_theta: float = 10000.0


@dataclasses.dataclass(frozen=True)
class TextConfig:
    hidden: int = 960
    layers: int = 12
    heads: int = 15
    kv_heads: int = 5
    mlp_hidden: int = 2560
    vocab: int = 49280
    rope_theta: float = 100000.0
    max_seq: int = 4096
    # Stack the decoder blocks into ONE nn.scan-ned block with [L, ...]
    # params (pipeline parallelism in the JAX package).
    scan_layers: bool = False
    # Mixture-of-experts FFN (0 = dense SwiGLU).
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # Stream K/V around this mesh axis (ring attention) instead of
    # all-gathering, for sequences too long for one chip.
    ring_axis: Optional[str] = None
    # HF-checkpoint fidelity knobs:
    attn_qkv_bias: bool = False  # Qwen2/2.5 text attention has q/k/v biases
    mlp_act: str = "silu"  # Gemma (ColPali) uses gelu_tanh GeGLU
    rms_offset: bool = False  # Gemma RMSNorm computes x * (1 + w)
    embed_scale: bool = False  # Gemma scales embeddings by sqrt(hidden)
    # PaliGemma is a prefix-LM: the whole embedding input (image + text) is
    # prompt, so HF builds a FULL bidirectional mask for the ColPali forward
    # (no labels, no generation). Llama/Qwen backbones stay causal.
    causal: bool = True
    # Qwen2.5-VL M-RoPE: half-dim frequency bands partitioned into
    # (temporal, height, width) sections. None = standard 1D RoPE.
    mrope_section: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class ColVLMConfig:
    """Full model config. ``spatial_merge`` 1 = ColSmol/ColPali, 2 = ColQwen2.5."""

    vision: VisionConfig = VisionConfig()
    text: TextConfig = TextConfig()
    embed_dim: int = DEFAULT_EMBED_DIM
    spatial_merge: int = 1
    image_token_id: int = 49190
    dtype: str = "bfloat16"
    remat: bool = False  # jax.checkpoint each block: trade FLOPs for HBM in training
    # HF-checkpoint fidelity knobs:
    proj_bias: bool = False  # colpali-engine custom_text_proj is Linear(bias=True)
    connector_bias: bool = True  # Idefics3 modality projection has NO bias
    # which HF export naming the converter should expect for this config
    hf_layout: str = "idefics3"  # idefics3 | paligemma | qwen2.5

    @classmethod
    def colsmol_500m(cls) -> "ColVLMConfig":
        """ColSmol-500M shape (SmolVLM2-500M backbone: SigLIP-B/16 + 500M LM)."""
        return cls(
            vision=VisionConfig(hidden=768, layers=12, heads=12, patch_pixels=3 * 16 * 16,
                                max_patches=18432, pixel_shuffle=4, attn_bias=True),
            text=TextConfig(hidden=960, layers=32, heads=15, kv_heads=5,
                            mlp_hidden=2560, vocab=49280),
            spatial_merge=1,
            proj_bias=True, connector_bias=False, hf_layout="idefics3",
        )

    @classmethod
    def colpali_v13(cls) -> "ColVLMConfig":
        """ColPali-v1.3 shape (PaliGemma-3B: SigLIP-So400m + Gemma-2B)."""
        return cls(
            vision=VisionConfig(hidden=1152, layers=27, heads=16, patch_pixels=3 * 14 * 14,
                                max_patches=1024, attn_bias=True),
            text=TextConfig(hidden=2048, layers=18, heads=8, kv_heads=1,
                            mlp_hidden=16384, vocab=257216, rope_theta=10000.0,
                            mlp_act="gelu_tanh", rms_offset=True,
                            embed_scale=True, causal=False),
            spatial_merge=1,
            image_token_id=257152,
            proj_bias=True, connector_bias=True, hf_layout="paligemma",
        )

    @classmethod
    def colqwen25_v02(cls) -> "ColVLMConfig":
        """ColQwen2.5-v0.2 shape (Qwen2.5-VL-3B: window-attn ViT + 2x2 merge)."""
        return cls(
            vision=VisionConfig(hidden=1280, layers=32, heads=16, patch_pixels=3 * 14 * 14,
                                max_patches=4096, window_side=8,
                                full_attn_layers=(7, 15, 23, 31),
                                attn_bias=True, mlp_gated=True, rms_norm=True,
                                patch_bias=False, learned_pos=False,
                                post_ln=False, rope_2d=True),
            text=TextConfig(hidden=2048, layers=36, heads=16, kv_heads=2,
                            mlp_hidden=11008, vocab=151936, rope_theta=1000000.0,
                            attn_qkv_bias=True, mrope_section=(16, 24, 24)),
            spatial_merge=2,
            image_token_id=151655,
            proj_bias=True, hf_layout="qwen2.5",
        )

    @classmethod
    def tiny(cls) -> "ColVLMConfig":
        """Test/dry-run scale."""
        return cls(
            vision=VisionConfig(hidden=64, layers=2, heads=4, patch_pixels=48,
                                max_patches=512),
            text=TextConfig(hidden=64, layers=2, heads=4, kv_heads=2,
                            mlp_hidden=128, vocab=512, max_seq=128),
            spatial_merge=1,
            image_token_id=500,
        )


_UNSUPPORTED = (
    ("text.moe_experts", lambda c: c.text.moe_experts > 0),
    ("text.scan_layers", lambda c: c.text.scan_layers),
    ("text.ring_axis", lambda c: c.text.ring_axis is not None),
    ("text.mrope_section", lambda c: c.text.mrope_section is not None),
    ("text.rms_offset", lambda c: c.text.rms_offset),
    ("text.embed_scale", lambda c: c.text.embed_scale),
    ("text.mlp_act", lambda c: c.text.mlp_act != "silu"),
    ("remat", lambda c: c.remat),
    ("spatial_merge", lambda c: c.spatial_merge > 1),
    ("vision.rope_2d", lambda c: c.vision.rope_2d),
    ("vision.mlp_gated", lambda c: c.vision.mlp_gated),
    ("vision.rms_norm", lambda c: c.vision.rms_norm),
)


def check_supported(cfg: ColVLMConfig) -> None:
    """Raise ``NotImplementedError`` naming the first field the port's
    ColVLM does not run (ColPali and ColQwen2.5 are later slices)."""
    for name, needs in _UNSUPPORTED:
        if needs(cfg):
            value = functools.reduce(getattr, name.split("."), cfg)
            raise NotImplementedError(f"the port's ColVLM does not run {name} = {value!r} "
                                      "yet (ColSmol-shaped configs only)")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[str(name)]


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias in ``dtype``.
    The weight is torch's ``[out, in]`` (flax's kernel transposed)."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: f32 statistics with the fast
    variance, epsilon 1e-6, f32 scale and bias, output in ``dtype``."""

    def __init__(self, dim: int, dtype, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = ((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu).clamp(min=0.0)
        y = (x32 - mu) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(self.dtype)


class RMSNorm(nn.Module):
    """``colvlm.py:233-247`` without Gemma's offset: f32 inside, output in
    the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        norm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim of [B, T, H, Dh] (rotate-half
    layout), angles in f32, the result cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].float() * freqs  # [B, T, half]
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class GQAttention(nn.Module):
    """Grouped-query attention with optional RoPE and causal masking. The
    kv heads go to :func:`mha` as they are, not repeated."""

    def __init__(self, hidden: int, heads: int, kv_heads: int, dtype, *,
                 rope_theta: Optional[float] = None, causal: bool = True,
                 qkv_bias: bool = False, out_bias: bool = False, device=None):
        super().__init__()
        self.heads, self.kv_heads, self.dh = heads, kv_heads, hidden // heads
        self.rope_theta, self.causal, self.dtype = rope_theta, causal, dtype
        self.use_flash = True
        kw = dict(dtype=dtype, device=device)
        self.q = Dense(hidden, heads * self.dh, bias=qkv_bias, **kw)
        self.k = Dense(hidden, kv_heads * self.dh, bias=qkv_bias, **kw)
        self.v = Dense(hidden, kv_heads * self.dh, bias=qkv_bias, **kw)
        self.o = Dense(heads * self.dh, hidden, bias=out_bias, **kw)

    def forward(self, x, mask, positions=None, segments=None):
        b, t, _ = x.shape
        q = self.q(x).view(b, t, self.heads, self.dh)
        k = self.k(x).view(b, t, self.kv_heads, self.dh)
        v = self.v(x).view(b, t, self.kv_heads, self.dh)
        if self.rope_theta is not None:
            if positions is None:
                positions = torch.arange(t, device=x.device).expand(b, t)
            q = _rope(q, positions, self.rope_theta)
            k = _rope(k, positions, self.rope_theta)
        out = mha(q, k, v, mask, causal=self.causal, dtype=self.dtype,
                  use_flash=self.use_flash, segments=segments)
        return self.o(out.reshape(b, t, self.heads * self.dh))


class SwiGLU(nn.Module):
    def __init__(self, hidden: int, mlp_hidden: int, dtype, device=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.gate = Dense(hidden, mlp_hidden, **kw)
        self.up = Dense(hidden, mlp_hidden, **kw)
        self.down = Dense(mlp_hidden, hidden, **kw)

    def forward(self, x):
        return self.down(F.silu(self.gate(x)) * self.up(x))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: TextConfig, dtype, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.hidden, device=device)
        self.attn = GQAttention(cfg.hidden, cfg.heads, cfg.kv_heads, dtype,
                                rope_theta=cfg.rope_theta, causal=cfg.causal,
                                qkv_bias=cfg.attn_qkv_bias, device=device)
        self.ln2 = RMSNorm(cfg.hidden, device=device)
        self.mlp = SwiGLU(cfg.hidden, cfg.mlp_hidden, dtype, device=device)

    def forward(self, x, mask, positions):
        h = x + self.attn(self.ln1(x), mask, positions)
        return h + self.mlp(self.ln2(h))


class ViTBlock(nn.Module):
    """SigLIP block: pre-LayerNorm attention, then the LayerNorm + GELU-tanh
    MLP with biases."""

    def __init__(self, cfg: VisionConfig, dtype, device=None):
        super().__init__()
        mlp = int(cfg.hidden * cfg.mlp_ratio)
        self.ln1 = LayerNorm(cfg.hidden, dtype, device=device)
        self.attn = GQAttention(cfg.hidden, cfg.heads, cfg.heads, dtype, causal=False,
                                qkv_bias=cfg.attn_bias, out_bias=cfg.attn_bias, device=device)
        self.ln2 = LayerNorm(cfg.hidden, dtype, device=device)
        self.fc1 = Dense(cfg.hidden, mlp, dtype=dtype, device=device)
        self.fc2 = Dense(mlp, cfg.hidden, dtype=dtype, device=device)

    def forward(self, x, mask, segments=None):
        h = x + self.attn(self.ln1(x), mask, segments=segments)
        return h + self.fc2(F.gelu(self.fc1(self.ln2(h)), approximate="tanh"))


def tile_position_ids(n: int, pixel_shuffle: int, device=None) -> torch.Tensor:
    """Row of the learned position table for each of n patches. With pixel
    shuffle s, positions index within each (8s)^2-patch tile, and each axis
    id is ``max(arange(side) - 1, 0)`` (Idefics3's bucketing quirk,
    ``colvlm.py:506-522``), so a tile's ids run [0, 0, 1, ..., side - 2] per
    axis."""
    side = 8 * pixel_shuffle
    bucket = (torch.arange(side, device=device) - 1).clamp(min=0)
    tile_pos = (bucket[:, None] * side + bucket[None, :]).reshape(-1)
    return tile_pos[torch.arange(n, device=device) % (side * side)]


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, dtype, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.patch_embed = Dense(cfg.patch_pixels, cfg.hidden, bias=cfg.patch_bias,
                                 dtype=dtype, device=device)
        if cfg.learned_pos:
            s = cfg.pixel_shuffle
            rows = (8 * s) ** 2 if s > 1 else cfg.max_patches
            self.pos_embed = nn.Parameter(torch.empty(rows, cfg.hidden, dtype=dtype,
                                                      device=device))
        self.blocks = nn.ModuleList(ViTBlock(cfg, dtype, device=device)
                                    for _ in range(cfg.layers))
        self.post_ln = LayerNorm(cfg.hidden, dtype, device=device) if cfg.post_ln else None

    def forward(self, patches, patch_mask, window_ids=None):
        b, n, _ = patches.shape
        if n > self.cfg.max_patches:
            raise ValueError(f"{n} patches exceeds vision.max_patches={self.cfg.max_patches}")
        x = self.patch_embed(patches.to(self.dtype))
        if self.cfg.learned_pos:
            if self.cfg.pixel_shuffle > 1:
                ids = tile_position_ids(n, self.cfg.pixel_shuffle, device=x.device)
                x = x + self.pos_embed[ids][None]
            else:
                x = x + self.pos_embed[:n][None]
        for i, blk in enumerate(self.blocks):
            seg = window_ids if window_ids is not None and i not in self.cfg.full_attn_layers \
                else None
            x = blk(x, patch_mask, segments=seg)
        return x if self.post_ln is None else self.post_ln(x)


def pixel_shuffle(feats: torch.Tensor, sps: int) -> torch.Tensor:
    """SmolVLM pixel shuffle in HF's op order (``colvlm.py:604-618``):
    [B, tiles * (8s)^2, H] -> [B, tiles * 64, H * s^2]."""
    b, n, h = feats.shape
    side = 8 * sps
    tiles = n // (side * side)
    x = feats.reshape(b * tiles, side, side, h)
    x = x.reshape(b * tiles, side, side // sps, h * sps)
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(b * tiles, side // sps, side // sps, h * sps * sps)
    x = x.permute(0, 2, 1, 3)
    return x.reshape(b, tiles * 64, h * sps * sps)


class ColVLM(nn.Module):
    """Late-interaction VLM: L2-normalized [B, L, embed_dim] f32 tokens."""

    def __init__(self, cfg: ColVLMConfig, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        self.dtype = dtype
        self.vision = VisionTower(cfg.vision, dtype, device=device)
        sps = cfg.vision.pixel_shuffle
        self.connector = Dense(cfg.vision.hidden * sps * sps, cfg.text.hidden,
                               bias=cfg.connector_bias, dtype=dtype, device=device)
        self.tok_embed = nn.Embedding(cfg.text.vocab, cfg.text.hidden, dtype=dtype,
                                      device=device)
        self.layers = nn.ModuleList(DecoderBlock(cfg.text, dtype, device=device)
                                    for _ in range(cfg.text.layers))
        self.final_norm = RMSNorm(cfg.text.hidden, device=device)
        self.proj = Dense(cfg.text.hidden, cfg.embed_dim, bias=cfg.proj_bias, dtype=dtype,
                          device=device)
        self._use_flash = True

    @property
    def use_flash(self) -> bool:
        return self._use_flash

    @use_flash.setter
    def use_flash(self, flag: bool) -> None:
        """Route every attention to K10 (True) or to the dense fallback."""
        self._use_flash = bool(flag)
        for m in self.modules():
            if isinstance(m, GQAttention):
                m.use_flash = self._use_flash

    def encode_images(self, patches, patch_mask, window_ids=None):
        """[B, N, patch_pixels] -> [B, N', text_hidden] image token embeddings."""
        feats = self.vision(patches, patch_mask, window_ids)
        if self.cfg.vision.pixel_shuffle > 1:
            feats = pixel_shuffle(feats, self.cfg.vision.pixel_shuffle)
        return self.connector(feats)

    def _lm(self, embeds, mask):
        positions = (torch.cumsum(mask.to(torch.int32), dim=1) - 1).clamp(min=0)
        h = embeds
        for blk in self.layers:
            h = blk(h, mask, positions)
        return self.final_norm(h)

    def _project(self, h, mask):
        e = self.proj(h).float()
        e = e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)
        return e * mask[..., None].float()

    def forward(self, input_ids, attn_mask, patches=None, patch_mask=None, window_ids=None):
        """Pages (ids holding image placeholders, filled with the image
        embeddings in order, as HF's masked_scatter does) or plain queries."""
        input_ids = input_ids.long()
        x = self.tok_embed(input_ids)
        if patches is not None:
            img = self.encode_images(patches, patch_mask, window_ids)  # [B, Ni, H]
            is_img = input_ids == self.cfg.image_token_id
            slot = (torch.cumsum(is_img.to(torch.int32), dim=1) - 1).clamp(0, img.shape[1] - 1)
            gathered = torch.gather(img, 1, slot[..., None].long().expand(-1, -1, img.shape[2]))
            x = torch.where(is_img[..., None], gathered.to(x.dtype), x)
        return self._project(self._lm(x, attn_mask), attn_mask)

    def embed_queries(self, input_ids, attn_mask):
        return self(input_ids, attn_mask)

    def embed_pages(self, input_ids, attn_mask, patches, patch_mask, window_ids=None):
        return self(input_ids, attn_mask, patches, patch_mask, window_ids)
