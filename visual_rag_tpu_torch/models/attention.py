"""Attention dispatch: the flash-attention kernel (K10), or the dense fallback.

Counterpart of ``visual_rag_tpu/models/attention.py:30-86``. Padding is
expressed as segment ids, built exactly as the JAX ``mha`` builds them
(``:44-48``): without ``segments``, valid tokens are segment 1 and pads
segment 0; with them (per-tile or window ids), valid tokens are
``segments + 1`` and pads 0. Tokens attend only within their segment.

- ``use_flash=True`` (the default): every attention goes to
  :func:`~visual_rag_tpu_torch.ops.kernels.flash_attention.flash_attention`,
  which launches K10 on a CUDA tensor and runs its plain version on a CPU
  tensor. There is no sequence-length rule: the JAX package's
  ``T >= 1024 and T % 128 == 0`` threshold (``:20-27``) is a v5e measurement.
- ``use_flash=False``: the JAX dense fallback's semantics (``:76-86``) on
  either device, the whole-model yardstick. It differs from K10 only on pad
  queries, which it lets average every key; nothing downstream reads those
  rows (the projection mask zeroes them and the image-slot merge never
  gathers them).

k and v may carry fewer heads than q; K10 reads each kv head in place, the
dense path repeats them as ``GQAttention`` does in JAX (``colvlm.py:288-290``).
"""

from __future__ import annotations

import torch

from visual_rag_tpu_torch.ops.kernels.flash_attention import flash_attention


def segment_ids(mask: torch.Tensor, segments=None) -> torch.Tensor:
    """int32 [B, T] segment ids of the JAX ``mha`` (pads 0)."""
    if segments is None:
        return mask.to(torch.int32)
    return torch.where(mask, segments.to(torch.int32) + 1, 0).to(torch.int32)


def mha(q, k, v, mask, *, causal: bool, dtype, use_flash: bool = True, segments=None,
        ring_axis=None):
    """Multi-head attention with padding mask and optional segment restriction.

    q: [B, T, Hq, Dh]; k, v: [B, T, Hkv, Dh] with Hq a multiple of Hkv; mask:
    [B, T] bool; segments: optional [B, T] int (tiles or windows). Returns
    [B, T, Hq, Dh] in ``dtype``.
    """
    if ring_axis is not None:
        raise NotImplementedError("ring attention (ring_axis) comes with the sharded slice")
    seg = segment_ids(mask, segments)
    if use_flash:
        return flash_attention(q.to(dtype), k.to(dtype), v.to(dtype), seg, causal=causal)
    return dense_attention(q, k, v, mask, seg, causal=causal, dtype=dtype)


def dense_attention(q, k, v, mask, seg, *, causal: bool, dtype) -> torch.Tensor:
    """The JAX dense fallback (``attention.py:76-86``): f32 logits, masked to
    the f32 minimum (a row with no allowed key averages every key), softmax
    weights cast to ``dtype`` before the product with v."""
    b, t, hq, dh = q.shape
    rep = hq // k.shape[2]
    if rep > 1:
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / float(dh) ** 0.5
    ok = mask[:, None, None, :] & (seg[:, None, :, None] == seg[:, None, None, :])
    if causal:
        ok = ok & torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(ok, logits, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.to(dtype))
