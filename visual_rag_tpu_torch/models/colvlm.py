"""ColVLM in PyTorch, for the configurations ColSmol-500M, ColPali-v1.3,
ColQwen2.5-v0.2 and Kimi-VL-A3B-Instruct run.

Counterpart of ``visual_rag_tpu/models/colvlm.py``. The four config
dataclasses and their classmethods (``:31-177``) are copied as they are, so
that a config means the same on both sides. The modules are the ones the
three models run: ``RMSNorm`` with Gemma's optional offset (``:233-247``),
``_rope`` with Qwen2.5-VL's M-RoPE sections (``:180-209``), the vision
tower's 2-D ``_rope_2d`` (``:212-230``), ``GQAttention`` (``:250-295``),
``SwiGLU`` with SiLU or Gemma's GeGLU, biased or not (``:298-312``),
``DecoderBlock`` (``:387-408``), ``ViTBlock`` with SigLIP's LayerNorm + GELU
MLP or Qwen2.5-VL's RMSNorm + biased SwiGLU (``:451-477``), ``VisionTower``
(``:480-534``; per-tile positions with the pixel shuffle, ``pos[:n]``
without it, none with the 2-D rotary), Qwen2.5-VL's ``PatchMerger``
(``:537-553``), and ``ColVLM`` with the pixel shuffle (``:604-618``), the
connector or the merger, the M-RoPE positions (``:620-652``), ``_lm``,
``_project``, the image-slot merge and PaliGemma's embedding scale
(``:654-709``). With ``cfg.remat`` each decoder and vision block is
rematerialized in training (``nn.remat``, ``:572-576``): ``torch.utils.
checkpoint`` without reentrance, whenever grad is enabled. A config that
needs more (the softmax MoE, scanned layers, ring attention) is refused with
a ``NotImplementedError`` naming the field.

New in the port, with no JAX counterpart (Kimi-VL, ``kimi_vl_a3b``; its
oracle is ``bench_port/reference/kimivl.py``): MoonViT's pieces in the
vision tower (``VisionConfig.moonvit_pos_grid``: the learned position table
interpolated to each page's grid, ``_rope_2d_pairs``, LayerNorms of
``norm_eps``, the projector as a ``PatchMerger`` with a LayerNorm and the
exact GELU); DeepSeek-V3's blocks in the decoder (``TextConfig.mla``:
``MLAttention``; ``TextConfig.routed_moe``: ``RoutedMoE``, whose experts run
on K11, ``ops/kernels/moe_experts.py``). Spans: ``vision.tower`` (count
``patches``) and ``text.decoder`` (``tokens``) around the two towers, and
``moe.experts`` (``tokens``, with the card's time) around each routed layer.

Numerics follow flax's: a ``Dense`` with ``dtype`` bf16 casts its input, its
kernel and its bias to bf16; ``LayerNorm`` takes its statistics in f32 with
the fast variance ``E[x^2] - E[x]^2`` and epsilon 1e-6, with f32 scale and
bias; ``RMSNorm`` runs in f32 with an f32 scale; RoPE angles are f32 and the
result is cast back (the 2-D rotary rotates an f32 copy of x); ``gelu`` is
the tanh approximation (flax's ``nn.gelu``, also in the PatchMerger); the
token table is cast to the model dtype whole and then indexed, the position
table indexed and then cast, as flax's ``Embed`` and ``pos[idx].astype``.

Parameter dtypes: ``ColVLM(cfg, param_dtype=None)`` stores the Dense layers
and the tables in the model dtype and the norm scales in f32 (serving: bf16
weights cost half the memory). ``param_dtype=torch.float32`` stores every
parameter in f32, as flax keeps them (``param_dtype`` f32), and each layer
casts its weight to the model dtype at use: the master weights of training,
where an AdamW update of ~1e-4 is below a bf16 ulp of most weights.

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
from torch.utils.checkpoint import checkpoint

from visual_rag_tpu_torch.models.attention import mha, mha_padded
from visual_rag_tpu_torch.ops.kernels.moe_experts import expert_layout, moe_experts
from visual_rag_tpu_torch.tracing import span

DEFAULT_EMBED_DIM = 128
# the decoder MLP's activations: SwiGLU's SiLU, Gemma's GeGLU (tanh GELU)
MLP_ACTS = {"silu": F.silu, "gelu_tanh": functools.partial(F.gelu, approximate="tanh")}


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
    # MoonViT (Kimi-VL): the side of its learned [G, G, hidden] position table,
    # interpolated bicubically to each image's patch grid (0 = none). > 0 also
    # selects its 2-D rotary on interleaved pairs (``_rope_2d_pairs``) and its
    # projector: a LayerNorm before the 2 x 2 merge and the exact GELU.
    moonvit_pos_grid: int = 0
    norm_eps: float = 1e-6  # the LayerNorms' epsilon (MoonViT's: 1e-5)


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
    rms_eps: float = 1e-6  # the RMSNorms' epsilon (DeepSeek-V3's: 1e-5)
    # DeepSeek-V3 blocks (Kimi-VL's text model): latent attention in every
    # layer, the sigmoid-routed experts after ``routed_moe.first_dense`` dense
    # layers. None = grouped-query attention, dense MLPs.
    mla: Optional["MLAConfig"] = None
    routed_moe: Optional["RoutedMoEConfig"] = None


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3's multi-head latent attention without a q LoRA: q from
    the hidden state ([heads, nope + rope]); one down-projection to the
    latent (``kv_lora_rank``) and a rope key shared by the heads; the
    latent RMS-normed (``kv_norm_eps``: its norm is built without the
    config's epsilon) and up-projected to each head's nope key and value."""

    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    kv_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class RoutedMoEConfig:
    """DeepSeek-V3's routed experts (``noaux_tc``, one group): sigmoid
    scores in f32, the ``top_k`` of score + ``e_score_correction_bias``,
    weights the chosen raw scores normalised (``norm_topk``) times
    ``scaling``; every token reaches its experts (no capacity). Beside them
    the shared experts as one SwiGLU ``shared_hidden`` wide. Layers below
    ``first_dense`` keep the dense MLP."""

    experts: int = 64
    top_k: int = 6
    expert_hidden: int = 1408
    shared_hidden: int = 2816
    first_dense: int = 1
    scaling: float = 2.446
    norm_topk: bool = True


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
    def kimi_vl_a3b(cls) -> "ColVLMConfig":
        """Kimi-VL-A3B-Instruct shape (MoonViT + a DeepSeek-V3-style MoE
        decoder with latent attention), under ColQwen's 128-wide retrieval
        head (no ColVLM checkpoint of it exists). ``vision.max_patches`` is
        the processor's ``in_token_limit`` before the pad to the 2 x 2
        merge; the image token is ``<|media_pad|>``."""
        return cls(
            vision=VisionConfig(hidden=1152, layers=27, heads=16, mlp_ratio=4304 / 1152,
                                patch_pixels=3 * 14 * 14, max_patches=4096, attn_bias=True,
                                rope_2d=True, moonvit_pos_grid=64, norm_eps=1e-5),
            text=TextConfig(hidden=2048, layers=27, heads=16, kv_heads=16,
                            mlp_hidden=11264, vocab=163840, rope_theta=800000.0,
                            rms_eps=1e-5, mla=MLAConfig(), routed_moe=RoutedMoEConfig()),
            spatial_merge=2,
            image_token_id=163605,
            proj_bias=True, hf_layout="kimi_vl",
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
    ("text.mlp_act", lambda c: c.text.mlp_act not in MLP_ACTS),
)


def check_supported(cfg: ColVLMConfig) -> None:
    """Raise ``NotImplementedError`` naming the first field the port's
    ColVLM does not run (the JAX package's softmax MoE with its capacity,
    scanned layers and ring attention come with the sharded slice, ROADMAP
    A8; an MLP activation outside ``MLP_ACTS``). The sigmoid-routed experts
    (``text.routed_moe``) run on one card."""
    for name, needs in _UNSUPPORTED:
        if needs(cfg):
            value = functools.reduce(getattr, name.split("."), cfg)
            raise NotImplementedError(f"the port's ColVLM does not run {name} = {value!r} "
                                      "yet (ColSmol-, ColPali-, ColQwen2.5- and "
                                      "Kimi-VL-shaped configs)")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[str(name)]


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to ``dtype``
    (the compute dtype) whatever the dtype they are stored in. The weight is
    torch's ``[out, in]`` (flax's kernel transposed)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=None,
                 device=None):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embed(nn.Module):
    """flax ``nn.Embed(dtype=...)``: the table cast to ``dtype`` whole, then
    indexed (so a bf16 model's repeated tokens sum their gradients in bf16,
    as flax's do)."""

    def __init__(self, num: int, dim: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, dim, dtype=dtype, device=device))

    def forward(self, ids):
        return F.embedding(ids, self.weight.to(self.dtype))


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
    """``colvlm.py:233-247``: f32 inside, output in the input's dtype. With
    ``offset`` (Gemma) the output is ``norm * (1 + scale)``, and the scale
    starts at zeros (``init_params``), as flax's does."""

    def __init__(self, dim: int, eps: float = 1e-6, offset: bool = False, device=None):
        super().__init__()
        self.eps, self.offset = eps, offset
        self.scale = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        norm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (norm * ((1.0 + self.scale) if self.offset else self.scale)).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
          mrope_section=None) -> torch.Tensor:
    """Rotary embedding over the last dim of [B, T, H, Dh] (rotate-half
    layout), angles in f32, the result cast back to x's dtype.

    positions: [B, T] (1-D), or [B, T, 3] with ``mrope_section`` (Qwen2.5-VL
    M-RoPE): the half-dim frequency bands fall into (temporal, height,
    width) sections and each band rotates by its own axis's position. 3-D
    positions without sections use axis 0."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    if mrope_section is not None and positions.dim() == 3:
        if sum(mrope_section) != half:
            raise ValueError(f"mrope_section {tuple(mrope_section)} does not sum to {half}")
        # band j takes the position of its section's axis (no host-to-device copy)
        ends = [sum(mrope_section[:a + 1]) for a in range(3)]
        angles = torch.cat([positions[..., a, None].float() * freqs[end - n:end]
                            for a, (n, end) in enumerate(zip(mrope_section, ends))],
                           dim=-1)  # [B, T, half]
    else:
        if positions.dim() == 3:
            positions = positions[..., 0]
        angles = positions[..., None].float() * freqs  # [B, T, half]
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _rope_2d(x: torch.Tensor, pos2d: torch.Tensor, theta: float) -> torch.Tensor:
    """Qwen2.5-VL's vision rotary over [B, T, H, Dh]: ``Dh / 4`` frequencies
    an axis, ``cat(row * inv, col * inv)`` repeated twice, rotate-half on an
    f32 copy of x, the result cast back. pos2d: [B, T, 2] (row, col)."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, 2, dtype=torch.float32, device=x.device)
                           / half))
    freqs = torch.cat([pos2d[..., 0:1].float() * inv, pos2d[..., 1:2].float() * inv], dim=-1)
    emb = torch.cat([freqs, freqs], dim=-1)[:, :, None, :]  # [B, T, 1, Dh]
    x32 = x.float()
    rotated = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * torch.cos(emb) + rotated * torch.sin(emb)).to(x.dtype)


def _rope_2d_pairs(x: torch.Tensor, pos2d: torch.Tensor, theta: float) -> torch.Tensor:
    """MoonViT's vision rotary over [B, T, H, Dh]: Dh / 2 interleaved pairs
    (2i, 2i + 1), each a complex number; pair 2m turns by ``col * inv[m]``
    and pair 2m + 1 by ``row * inv[m]``, ``inv[m] = theta ** (-4m / Dh)``
    (Dh / 4 frequencies an axis), on an f32 copy of x, the result cast back.
    pos2d: [B, T, 2] (row, col)."""
    b, t, h, dh = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, dh, 4, dtype=torch.float32, device=x.device)
                           [: dh // 4] / dh))
    ang = torch.stack([pos2d[..., 1:2].float() * inv, pos2d[..., 0:1].float() * inv], dim=-1)
    ang = ang.reshape(b, t, 1, dh // 2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x32 = x.float().reshape(b, t, h, dh // 2, 2)
    re, im = x32[..., 0], x32[..., 1]
    return torch.stack([re * cos - im * sin, re * sin + im * cos], dim=-1).reshape(
        b, t, h, dh).to(x.dtype)


def _rope_deepseek(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """DeepSeek-V3's rotary over [B, T, H, d]: the pairs (2i, 2i + 1) turned
    by ``position * theta ** (-2i / d)``, written de-interleaved (the even
    elements, then the odd ones), as its ``apply_rotary_pos_emb`` leaves
    them: :func:`_rope` of the de-interleaved x. q and k share the layout,
    so their dot products are those of the pair rotation."""
    b, t, h, d = x.shape
    x = x.reshape(b, t, h, d // 2, 2).transpose(-1, -2).reshape(b, t, h, d)
    return _rope(x, positions, theta)


class GQAttention(nn.Module):
    """Grouped-query attention with optional RoPE (1-D, M-RoPE or the vision
    tower's 2-D rotary) and causal masking. The kv heads go to :func:`mha`
    as they are, not repeated."""

    def __init__(self, hidden: int, heads: int, kv_heads: int, dtype, *,
                 rope_theta: Optional[float] = None, causal: bool = True,
                 qkv_bias: bool = False, out_bias: bool = False,
                 rope_2d_theta: Optional[float] = None, mrope_section=None,
                 rope_2d_pairs: bool = False, device=None):
        super().__init__()
        self.heads, self.kv_heads, self.dh = heads, kv_heads, hidden // heads
        self.rope_theta, self.causal, self.dtype = rope_theta, causal, dtype
        self.rope_2d_theta, self.mrope_section = rope_2d_theta, mrope_section
        self.rope_2d = _rope_2d_pairs if rope_2d_pairs else _rope_2d
        self.use_flash = True
        kw = dict(dtype=dtype, device=device)
        self.q = Dense(hidden, heads * self.dh, bias=qkv_bias, **kw)
        self.k = Dense(hidden, kv_heads * self.dh, bias=qkv_bias, **kw)
        self.v = Dense(hidden, kv_heads * self.dh, bias=qkv_bias, **kw)
        self.o = Dense(heads * self.dh, hidden, bias=out_bias, **kw)

    def forward(self, x, mask, positions=None, segments=None, positions_2d=None):
        """The 2-D rotary where ``rope_2d_theta`` is set and ``positions_2d``
        given, else 1-D or M-RoPE where ``rope_theta`` is set, else none
        (``colvlm.py:280-287``)."""
        b, t, _ = x.shape
        q = self.q(x).view(b, t, self.heads, self.dh)
        k = self.k(x).view(b, t, self.kv_heads, self.dh)
        v = self.v(x).view(b, t, self.kv_heads, self.dh)
        if self.rope_2d_theta is not None and positions_2d is not None:
            q = self.rope_2d(q, positions_2d, self.rope_2d_theta)
            k = self.rope_2d(k, positions_2d, self.rope_2d_theta)
        elif self.rope_theta is not None:
            if positions is None:
                positions = torch.arange(t, device=x.device).expand(b, t)
            q = _rope(q, positions, self.rope_theta, self.mrope_section)
            k = _rope(k, positions, self.rope_theta, self.mrope_section)
        out = mha(q, k, v, mask, causal=self.causal, dtype=self.dtype,
                  use_flash=self.use_flash, segments=segments)
        return self.o(out.reshape(b, t, self.heads * self.dh))


class MLAttention(nn.Module):
    """DeepSeek-V3's latent attention (:class:`MLAConfig`), causal, with its
    rotary on the rope parts of q and of the shared key, in its un-absorbed
    form (the latent up-projected to every head's key and value). The
    attention goes to K10 at head dim 256 (``mha_padded``: q and k of
    ``nope + rope`` = 192 and v of 128 zero-padded, the scale 192 ** -0.5,
    the output cut back), exactly the 192 / 128 attention; at Kimi-VL's
    widths its FLOPs are ~1.5% of a page's."""

    KERNEL_DH = 256

    def __init__(self, hidden: int, heads: int, mla: MLAConfig, rope_theta: float, dtype,
                 device=None):
        super().__init__()
        self.heads, self.mla, self.rope_theta, self.dtype = heads, mla, rope_theta, dtype
        self.qk_dim = mla.qk_nope_dim + mla.qk_rope_dim
        self.use_flash = True
        kw = dict(bias=False, dtype=dtype, device=device)
        self.q = Dense(hidden, heads * self.qk_dim, **kw)
        self.kv_a = Dense(hidden, mla.kv_lora_rank + mla.qk_rope_dim, **kw)
        self.kv_norm = RMSNorm(mla.kv_lora_rank, eps=mla.kv_norm_eps, device=device)
        self.kv_b = Dense(mla.kv_lora_rank, heads * (mla.qk_nope_dim + mla.v_dim), **kw)
        self.o = Dense(heads * mla.v_dim, hidden, **kw)

    def forward(self, x, mask, positions=None):
        b, t, _ = x.shape
        m, h = self.mla, self.heads
        if positions is None:
            positions = torch.arange(t, device=x.device).expand(b, t)
        q = self.q(x).view(b, t, h, self.qk_dim)
        kv_a = self.kv_a(x)
        kv = self.kv_b(self.kv_norm(kv_a[..., :m.kv_lora_rank])).view(
            b, t, h, m.qk_nope_dim + m.v_dim)
        q_pe = _rope_deepseek(q[..., m.qk_nope_dim:], positions, self.rope_theta)
        k_pe = _rope_deepseek(kv_a[..., None, m.kv_lora_rank:], positions, self.rope_theta)
        q = torch.cat([q[..., :m.qk_nope_dim], q_pe], dim=-1)
        k = torch.cat([kv[..., :m.qk_nope_dim], k_pe.expand(b, t, h, m.qk_rope_dim)], dim=-1)
        out = mha_padded(q, k, kv[..., m.qk_nope_dim:], mask, causal=True, dtype=self.dtype,
                         to=self.KERNEL_DH, use_flash=self.use_flash)
        return self.o(out.reshape(b, t, h * m.v_dim))


class SwiGLU(nn.Module):
    """Gated MLP: ``down(act(gate(x)) * up(x))``, ``act`` a key of
    ``MLP_ACTS`` (``"gelu_tanh"``: Gemma's GeGLU); ``use_bias``: Qwen2.5-VL's
    vision MLP."""

    def __init__(self, hidden: int, mlp_hidden: int, dtype, act: str = "silu",
                 use_bias: bool = False, device=None):
        super().__init__()
        kw = dict(bias=use_bias, dtype=dtype, device=device)
        self.act = MLP_ACTS[act]
        self.gate = Dense(hidden, mlp_hidden, **kw)
        self.up = Dense(hidden, mlp_hidden, **kw)
        self.down = Dense(mlp_hidden, hidden, **kw)

    def forward(self, x):
        return self.down(self.act(self.gate(x)) * self.up(x))


class Stacked(nn.Module):
    """``count`` Dense kernels of one shape: ``weight`` [count, out, in]."""

    def __init__(self, count: int, n_in: int, n_out: int, dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(count, n_out, n_in, dtype=dtype, device=device))


class Router(nn.Module):
    """DeepSeek-V3's gate: ``weight`` [experts, hidden] and
    ``e_score_correction_bias`` (``bias``) [experts], both f32, as the gate
    casts them."""

    def __init__(self, hidden: int, experts: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, hidden, device=device))
        self.bias = nn.Parameter(torch.empty(experts, device=device))


class RoutedMoE(nn.Module):
    """The sigmoid-routed experts (:class:`RoutedMoEConfig`) beside the
    shared experts, on one card.

    Routing runs in f32 (logits, sigmoid scores, the bias). Tokens go to
    their experts on the device with no host synchronise:
    ``ops/kernels/moe_experts.py::expert_layout`` sorts the (token, expert)
    pairs by expert with per-expert offsets computed on the device, and
    ``moe_experts`` runs every expert's SwiGLU over its rows (K11 on the
    card) and adds each token's weighted rows to the shared experts'
    output. ``stats`` reads the per-expert token counts, summed over every
    forward since the model was built, on demand (the forward only adds
    them up on the device)."""

    def __init__(self, hidden: int, cfg: RoutedMoEConfig, dtype, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.router = Router(hidden, cfg.experts, device=device)
        self.experts = nn.Module()
        self.experts.gate = Stacked(cfg.experts, hidden, cfg.expert_hidden, dtype, device)
        self.experts.up = Stacked(cfg.experts, hidden, cfg.expert_hidden, dtype, device)
        self.experts.down = Stacked(cfg.experts, cfg.expert_hidden, hidden, dtype, device)
        self.shared = SwiGLU(hidden, cfg.shared_hidden, dtype, device=device)
        self._tokens: Optional[torch.Tensor] = None

    def route(self, x: torch.Tensor):
        """(experts [N, top_k] int64, weights [N, top_k] f32) of rows x [N, hidden]."""
        scores = torch.sigmoid(F.linear(x.float(), self.router.weight.float()))
        idx = torch.topk(scores + self.router.bias.float(), self.cfg.top_k, dim=-1).indices
        w = scores.gather(1, idx)
        if self.cfg.norm_topk:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return idx, w * self.cfg.scaling

    def forward(self, x):
        b, t, h = x.shape
        flat = x.reshape(b * t, h)
        with span("moe.experts", device=x.device, tokens=b * t):
            idx, w = self.route(flat)
            layout = expert_layout(idx, self.cfg.experts)
            e = self.experts
            out = moe_experts(flat.to(self.dtype), e.gate.weight.to(self.dtype),
                              e.up.weight.to(self.dtype), e.down.weight.to(self.dtype),
                              layout, w, base=self.shared(flat))
            if self._tokens is None or self._tokens.device != x.device:
                self._tokens = torch.zeros(self.cfg.experts, dtype=torch.int64, device=x.device)
            self._tokens += layout.counts
        return out.view(b, t, h)

    @property
    def stats(self) -> dict:
        """{"tokens": the rows each expert took, summed over every forward
        so far, a batch's padded rows among them} (a copy to the host: a
        synchronise, so only on demand)."""
        tokens = (torch.zeros(self.cfg.experts, dtype=torch.int64) if self._tokens is None
                  else self._tokens.cpu())
        return {"tokens": tokens}


class DecoderBlock(nn.Module):
    """A decoder layer: grouped-query attention, or latent attention with
    ``cfg.mla``; a dense gated MLP, or with ``cfg.routed_moe`` the routed
    experts from layer ``first_dense`` on (``index``: the layer's)."""

    def __init__(self, cfg: TextConfig, dtype, device=None, index: int = 0):
        super().__init__()
        self.ln1 = RMSNorm(cfg.hidden, eps=cfg.rms_eps, offset=cfg.rms_offset, device=device)
        if cfg.mla is not None:
            self.attn = MLAttention(cfg.hidden, cfg.heads, cfg.mla, cfg.rope_theta, dtype,
                                    device=device)
        else:
            self.attn = GQAttention(cfg.hidden, cfg.heads, cfg.kv_heads, dtype,
                                    rope_theta=cfg.rope_theta, causal=cfg.causal,
                                    qkv_bias=cfg.attn_qkv_bias,
                                    mrope_section=cfg.mrope_section, device=device)
        self.ln2 = RMSNorm(cfg.hidden, eps=cfg.rms_eps, offset=cfg.rms_offset, device=device)
        moe = cfg.routed_moe
        if moe is not None and index >= moe.first_dense:
            self.mlp = RoutedMoE(cfg.hidden, moe, dtype, device=device)
        else:
            self.mlp = SwiGLU(cfg.hidden, cfg.mlp_hidden, dtype, act=cfg.mlp_act, device=device)

    def forward(self, x, mask, positions):
        h = x + self.attn(self.ln1(x), mask, positions)
        return h + self.mlp(self.ln2(h))


class ViTBlock(nn.Module):
    """Pre-norm vision block. SigLIP: LayerNorms and the biased GELU-tanh MLP
    (``fc1``, ``fc2``). Qwen2.5-VL (``rms_norm``, ``mlp_gated``,
    ``rope_2d``): RMSNorms, the biased SiLU ``SwiGLU`` named ``mlp`` and the
    2-D rotary from ``positions_2d``."""

    def __init__(self, cfg: VisionConfig, dtype, device=None):
        super().__init__()
        mlp = int(cfg.hidden * cfg.mlp_ratio)

        def norm():
            if cfg.rms_norm:
                return RMSNorm(cfg.hidden, device=device)
            return LayerNorm(cfg.hidden, dtype, eps=cfg.norm_eps, device=device)

        self.ln1 = norm()
        self.attn = GQAttention(cfg.hidden, cfg.heads, cfg.heads, dtype, causal=False,
                                qkv_bias=cfg.attn_bias, out_bias=cfg.attn_bias,
                                rope_2d_theta=cfg.rope_theta if cfg.rope_2d else None,
                                rope_2d_pairs=cfg.moonvit_pos_grid > 0, device=device)
        self.ln2 = norm()
        self.gated = cfg.mlp_gated
        if cfg.mlp_gated:
            self.mlp = SwiGLU(cfg.hidden, mlp, dtype, use_bias=True, device=device)
        else:
            self.fc1 = Dense(cfg.hidden, mlp, dtype=dtype, device=device)
            self.fc2 = Dense(mlp, cfg.hidden, dtype=dtype, device=device)

    def forward(self, x, mask, segments=None, positions_2d=None):
        h = x + self.attn(self.ln1(x), mask, segments=segments, positions_2d=positions_2d)
        y = self.ln2(h)
        if self.gated:
            return h + self.mlp(y)
        return h + self.fc2(F.gelu(self.fc1(y), approximate="tanh"))


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


def run_block(blk: nn.Module, remat: bool, *args, **kwargs):
    """``blk(*args, **kwargs)``, rematerialized in the backward when
    ``remat`` is set and grad is enabled (flax ``nn.remat``)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(blk, *args, use_reentrant=False, **kwargs)
    return blk(*args, **kwargs)


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, dtype, device=None, remat: bool = False):
        super().__init__()
        self.cfg, self.dtype, self.remat = cfg, dtype, remat
        self.patch_embed = Dense(cfg.patch_pixels, cfg.hidden, bias=cfg.patch_bias,
                                 dtype=dtype, device=device)
        g = cfg.moonvit_pos_grid
        if cfg.learned_pos:
            s = cfg.pixel_shuffle
            rows = (8 * s) ** 2 if s > 1 else cfg.max_patches
            shape = (g, g, cfg.hidden) if g else (rows, cfg.hidden)
            self.pos_embed = nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
        self.blocks = nn.ModuleList(ViTBlock(cfg, dtype, device=device)
                                    for _ in range(cfg.layers))
        self.post_ln = (LayerNorm(cfg.hidden, dtype, eps=cfg.norm_eps, device=device)
                        if cfg.post_ln else None)

    def grid_positions(self, patch_positions, grids) -> torch.Tensor:
        """MoonViT's learned positions [B, N, hidden]: the [G, G, hidden]
        table interpolated bicubically (``align_corners=False``, in f32) to
        each image's (rows, cols) grid, read at each patch's (row, col) and
        cast to the model dtype; pads read row 0 (nothing reads their
        outputs). ``grids``: each image's (rows, cols), host ints."""
        if patch_positions is None or grids is None:
            raise ValueError("MoonViT's positions need patch_positions and grids")
        table = self.pos_embed.float().permute(2, 0, 1)[None]
        tables, out = {}, []
        for b, (gh, gw) in enumerate(grids):
            gh, gw = int(gh), int(gw)
            if (gh, gw) not in tables:
                grid = F.interpolate(table, size=(gh, gw), mode="bicubic", align_corners=False)
                tables[gh, gw] = grid[0].permute(1, 2, 0).reshape(gh * gw, -1).to(self.dtype)
            pos = patch_positions[b].long()
            out.append(tables[gh, gw][(pos[:, 0] * gw + pos[:, 1]).clamp(0, gh * gw - 1)])
        return torch.stack(out)

    def forward(self, patches, patch_mask, window_ids=None, patch_positions=None, grids=None):
        b, n, _ = patches.shape
        # MoonViT's grid is padded to the 2 x 2 merge after its token limit is met
        if n > self.cfg.max_patches and not self.cfg.moonvit_pos_grid:
            raise ValueError(f"{n} patches exceeds vision.max_patches={self.cfg.max_patches}")
        x = self.patch_embed(patches.to(self.dtype))
        if self.cfg.learned_pos:
            if self.cfg.moonvit_pos_grid:
                x = x + self.grid_positions(patch_positions, grids)
            elif self.cfg.pixel_shuffle > 1:
                ids = tile_position_ids(n, self.cfg.pixel_shuffle, device=x.device)
                x = x + self.pos_embed[ids][None].to(self.dtype)
            else:
                x = x + self.pos_embed[:n][None].to(self.dtype)
        for i, blk in enumerate(self.blocks):
            seg = window_ids if window_ids is not None and i not in self.cfg.full_attn_layers \
                else None
            x = run_block(blk, self.remat, x, patch_mask, segments=seg,
                          positions_2d=patch_positions)
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


class PatchMerger(nn.Module):
    """Qwen2.5-VL's 2 x 2 merge (``colvlm.py:537-553``): RMSNorm ``ln_q``,
    each ``merge ** 2`` consecutive patches (the processor's merge-block
    order) folded into one row, then ``fc1``, tanh GELU, ``fc2``. With
    ``moonvit_eps`` it is Kimi-VL's projector: ``ln_q`` a LayerNorm of that
    epsilon and the exact GELU."""

    def __init__(self, hidden: int, out_hidden: int, merge: int, dtype, device=None,
                 moonvit_eps: Optional[float] = None):
        super().__init__()
        m2 = merge * merge
        self.m2 = m2
        if moonvit_eps is None:
            self.ln_q = RMSNorm(hidden, device=device)
        else:
            self.ln_q = LayerNorm(hidden, dtype, eps=moonvit_eps, device=device)
        self.approximate = "tanh" if moonvit_eps is None else "none"
        self.fc1 = Dense(m2 * hidden, m2 * hidden, dtype=dtype, device=device)
        self.fc2 = Dense(m2 * hidden, out_hidden, dtype=dtype, device=device)

    def forward(self, x):
        b, n, h = x.shape
        x = self.ln_q(x).reshape(b, n // self.m2, self.m2 * h)
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class ColVLM(nn.Module):
    """Late-interaction VLM: L2-normalized [B, L, embed_dim] f32 tokens."""

    def __init__(self, cfg: ColVLMConfig, device=None, param_dtype=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        self.dtype = dtype
        self.vision = VisionTower(cfg.vision, dtype, device=device, remat=cfg.remat)
        if cfg.spatial_merge > 1:
            moonvit = cfg.vision.norm_eps if cfg.vision.moonvit_pos_grid else None
            self.merger = PatchMerger(cfg.vision.hidden, cfg.text.hidden, cfg.spatial_merge,
                                      dtype, device=device, moonvit_eps=moonvit)
        else:
            sps = cfg.vision.pixel_shuffle
            self.connector = Dense(cfg.vision.hidden * sps * sps, cfg.text.hidden,
                                   bias=cfg.connector_bias, dtype=dtype, device=device)
        self.tok_embed = Embed(cfg.text.vocab, cfg.text.hidden, dtype, device=device)
        self.layers = nn.ModuleList(DecoderBlock(cfg.text, dtype, device=device, index=i)
                                    for i in range(cfg.text.layers))
        self.final_norm = RMSNorm(cfg.text.hidden, eps=cfg.text.rms_eps,
                                  offset=cfg.text.rms_offset, device=device)
        self.proj = Dense(cfg.text.hidden, cfg.embed_dim, bias=cfg.proj_bias, dtype=dtype,
                          device=device)
        if param_dtype is not None:  # every parameter, as flax's param_dtype
            self.to(dtype=param_dtype)
        self._use_flash = True

    @property
    def use_flash(self) -> bool:
        return self._use_flash

    @use_flash.setter
    def use_flash(self, flag: bool) -> None:
        """Route every attention to K10 (True) or to the dense fallback."""
        self._use_flash = bool(flag)
        for m in self.modules():
            if isinstance(m, (GQAttention, MLAttention)):
                m.use_flash = self._use_flash

    def encode_images(self, patches, patch_mask, window_ids=None, patch_positions=None,
                      grids=None):
        """[B, N, patch_pixels] -> [B, N', text_hidden] image token embeddings.
        ``grids``: each image's (rows, cols) patch grid, host ints (MoonViT's
        interpolated positions; unread by the other towers)."""
        b, n = patches.shape[:2]
        with span("vision.tower", patches=b * n):
            feats = self.vision(patches, patch_mask, window_ids, patch_positions, grids)
        if self.cfg.spatial_merge > 1:
            return self.merger(feats)
        if self.cfg.vision.pixel_shuffle > 1:
            feats = pixel_shuffle(feats, self.cfg.vision.pixel_shuffle)
        return self.connector(feats)

    def _mrope_positions(self, input_ids, attn_mask, patch_positions=None):
        """int [B, L, 3] (t, h, w) M-RoPE positions, HF ``get_rope_index``
        (``colvlm.py:620-652``): text tokens carry equal positions on the
        three axes; an image token carries (base, base + row, base + col) of
        its merged grid cell; an image block advances the counter by
        ``max(h, w) + 1`` of its last cell. Without patches (queries) every
        axis is the 1-D position."""
        mask_i = attn_mask.to(torch.int64)
        if patch_positions is None:
            base = (torch.cumsum(mask_i, dim=1) - 1).clamp(min=0)
            return base[..., None].expand(-1, -1, 3)
        is_img = (input_ids == self.cfg.image_token_id) & (mask_i > 0)
        m = self.cfg.spatial_merge
        merged = patch_positions[:, ::m * m, :].to(torch.int64) // m  # [B, Ni, 2]
        slot = (torch.cumsum(is_img.to(torch.int64), dim=1) - 1).clamp(0, merged.shape[1] - 1)
        h_c = torch.gather(merged[..., 0], 1, slot)
        w_c = torch.gather(merged[..., 1], 1, slot)
        next_img = torch.cat([is_img[:, 1:], torch.zeros_like(is_img[:, :1])], dim=1)
        block_end = is_img & ~next_img
        adv = torch.where(is_img, torch.where(block_end, torch.maximum(h_c, w_c) + 1, 0),
                          mask_i) * mask_i
        base = torch.cumsum(adv, dim=1) - adv  # the position before each token
        return torch.stack([base, base + torch.where(is_img, h_c, 0),
                            base + torch.where(is_img, w_c, 0)], dim=-1)

    def _lm(self, embeds, mask, positions=None):
        if positions is None:
            positions = (torch.cumsum(mask.to(torch.int32), dim=1) - 1).clamp(min=0)
        h = embeds
        with span("text.decoder", tokens=h.shape[0] * h.shape[1]):
            for blk in self.layers:
                h = run_block(blk, self.cfg.remat, h, mask, positions)
            return self.final_norm(h)

    def _project(self, h, mask):
        e = self.proj(h).float()
        e = e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)
        return e * mask[..., None].float()

    def _scaled(self, x, power: float):
        """``x * hidden ** power`` in x's dtype, the factor rounded to it
        first, as JAX multiplies an array by a weak-typed python float (the
        rounding is made on the host: no copy to the device)."""
        return x * float(torch.tensor(self.cfg.text.hidden ** power, dtype=x.dtype))

    def forward(self, input_ids, attn_mask, patches=None, patch_mask=None, window_ids=None,
                patch_positions=None, grids=None):
        """Pages (ids holding image placeholders, filled with the image
        embeddings in order, as HF's masked_scatter does) or plain queries.
        With ``text.embed_scale`` (PaliGemma) the image features are divided
        by sqrt(hidden) before the merge and the whole sequence multiplied
        by it after (``colvlm.py:683-694``). With ``text.mrope_section``
        (Qwen2.5-VL) the text model rotates by :meth:`_mrope_positions`."""
        input_ids = input_ids.long()
        x = self.tok_embed(input_ids)
        if patches is not None:
            img = self.encode_images(patches, patch_mask, window_ids,
                                     patch_positions, grids)  # [B, Ni, H]
            if self.cfg.text.embed_scale:
                img = self._scaled(img, -0.5)
            is_img = input_ids == self.cfg.image_token_id
            slot = (torch.cumsum(is_img.to(torch.int32), dim=1) - 1).clamp(0, img.shape[1] - 1)
            gathered = torch.gather(img, 1, slot[..., None].long().expand(-1, -1, img.shape[2]))
            x = torch.where(is_img[..., None], gathered.to(x.dtype), x)
        if self.cfg.text.embed_scale:
            x = self._scaled(x, 0.5)
        positions = None
        if self.cfg.text.mrope_section is not None:
            positions = self._mrope_positions(
                input_ids, attn_mask, patch_positions if patches is not None else None)
        return self._project(self._lm(x, attn_mask, positions), attn_mask)

    def embed_queries(self, input_ids, attn_mask):
        return self(input_ids, attn_mask)

    def embed_pages(self, input_ids, attn_mask, patches, patch_mask, window_ids=None,
                    patch_positions=None, grids=None):
        return self(input_ids, attn_mask, patches, patch_mask, window_ids, patch_positions,
                    grids)
