"""Flash-attention forward with segment ids (K10).

Counterpart of the library kernel that ``visual_rag_tpu/models/attention.py``
calls (``:61-73``): ``jax/experimental/pallas/ops/tpu/flash_attention.py``,
forward ``_flash_attention_impl`` (``pallas_call`` at ``:758``), with the
semantics of its ``mha_reference`` (``:1530``). Forward only: the two
backward kernels (``:1121``, ``:1456``) come with training.

Layout is the JAX package's ``mha`` layout, ``[B, T, H, Dh]``; k and v may
carry fewer heads than q (head h reads kv head ``h // (Hq // Hkv)``), so
grouped-query attention never repeats them in memory. Key j is allowed for
row i when ``seg[b, j] == seg[b, i]`` and, under ``causal``, ``j <= i``; a
pad query (segment 0) attends the pad keys. Logits, maxima and sums are f32,
the output is in the input dtype, and a row with no allowed key is zeros.

On a CUDA tensor :func:`flash_attention` launches ``csrc/flash_attention.cu``
(f32 or bf16, ``Dh`` 64, 72, 80, 128 or 256: ColSmol-500M's two towers,
ColPali's vision tower and its Gemma text model, ColQwen2.5's vision tower
and its Qwen2.5 text model) or raises; on a CPU tensor it runs
:func:`flash_attention_plain`, which takes any ``Dh``.
"""

from __future__ import annotations

from typing import Optional

import torch

from visual_rag_tpu_torch.ops.kernels import _build
from visual_rag_tpu_torch.ops.kernels._checks import on_cpu, ptr, stream_ptr

KERNEL_HEAD_DIMS = (64, 72, 80, 128, 256)  # the instances of csrc/flash_attention.cu
TILE = 64  # rows a query tile
MIN_KV_TILE = 32  # keys of the smallest kv tile (Dh 256): the tile-range scratch is sized by it
MAX_TILES = 16384  # csrc/flash_attention.cu MAX_TILES, in query tiles
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(q, k, v, seg) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, T, H, Dh]")
    b, t, hq, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, t) or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"{hq} query heads are not a multiple of {k.shape[2]} kv heads")
    if seg.shape != (b, t) or seg.dtype != torch.int32:
        raise ValueError(f"seg must be int32 [{b}, {t}], got {seg.dtype} {tuple(seg.shape)}")
    if not (q.device == k.device == v.device == seg.device):
        raise ValueError("q, k, v and seg must be on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg: torch.Tensor, *,
                    causal: bool, sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention output [B, T, Hq, Dh] in q's dtype (module docstring).

    ``sm_scale`` defaults to ``Dh ** -0.5``, the JAX ``mha``'s."""
    _check_args(q, k, v, seg)
    b, t, hq, dh = q.shape
    scale = float(dh) ** -0.5 if sm_scale is None else float(sm_scale)
    if on_cpu(q):
        return flash_attention_plain(q, k, v, seg, causal=causal, sm_scale=scale)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the flash-attention kernel takes f32 or bf16 q, k and v, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash-attention kernel takes head dims {KERNEL_HEAD_DIMS}, "
                         f"got {dh}")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(s % vec for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{name} rows must be contiguous and 16-byte aligned "
                             f"(strides {x.stride()})")
    n_tiles = -(-t // TILE)
    if n_tiles > MAX_TILES or hq > 65535 or b > 65535:
        raise ValueError(f"the flash-attention kernel does not take B {b}, T {t}, Hq {hq}")
    out = torch.empty((b, t, hq, dh), dtype=q.dtype, device=q.device)
    if b == 0 or t == 0:
        return out
    seg = seg.contiguous()
    ranges = torch.empty((b, -(-t // MIN_KV_TILE), 2), dtype=torch.int32, device=q.device)
    lib = _build.load_library()
    err = lib.vrt_flash_attention(
        q.device.index, _DTYPE_CODES[q.dtype], ptr(q), ptr(k), ptr(v), ptr(seg), ptr(ranges),
        ptr(out), b, t, hq, k.shape[2], dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(bool(causal)), scale, stream_ptr(q.device))
    _build.check(err, "flash_attention launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def allowed_pairs(seg: torch.Tensor, causal: bool) -> torch.Tensor:
    """bool [T, T] for one batch row: key j allowed for query i."""
    ok = seg[:, None] == seg[None, :]
    if causal:
        ok &= torch.ones_like(ok).tril()
    return ok


def flash_attention_plain(q, k, v, seg, *, causal: bool,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`: a dense f32 softmax
    over the allowed keys of each row, one (batch row, head) at a time so
    that its [T, T] transient stays about 1.2 GB at T = 17408."""
    _check_args(q, k, v, seg)
    b, t, hq, dh = q.shape
    group = hq // k.shape[2]
    scale = float(dh) ** -0.5 if sm_scale is None else float(sm_scale)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for bi in range(b):
        masked = ~allowed_pairs(seg[bi], causal)
        for h in range(hq):
            s = q[bi, :, h].float() @ k[bi, :, h // group].float().T
            s.mul_(scale).masked_fill_(masked, float("-inf"))
            mx = s.amax(dim=1, keepdim=True)
            s.sub_(torch.where(torch.isfinite(mx), mx, 0.0)).exp_()
            den = s.sum(dim=1, keepdim=True)
            o = (s @ v[bi, :, h // group].float()) / torch.where(den > 0, den, 1.0)
            out[bi, :, h] = o.to(q.dtype)
            del s
    return out
