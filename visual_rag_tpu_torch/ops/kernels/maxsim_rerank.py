"""Stage-2 rerank: exact MaxSim of each query against its own K candidates.

Port of ``visual_rag_tpu/ops/kernels/maxsim_rerank.py:95-181``
(``rerank_candidates``) for float and int8 stores. On a CUDA tensor the
wrapper launches the hand-written kernel in ``csrc/maxsim_rerank.cu``; on a
CPU tensor it runs the plain PyTorch version :func:`rerank_candidates_ref`,
ported from ``visual_rag_tpu/retrieval/batch.py:474-508``
(``xla_rerank_batch``, chunked over K). Both score -1 candidates and
0-token docs ``NEG_INF``, as the TPU kernel does (``:177-181``).

Queries are rounded to the store dtype, and to bf16 for int8 codes, as the
TPU kernel rounds them (``:171``); the per-doc scale multiplies the finished
score (``:89``). The JAX package's XLA fallback keeps f32 queries on int8
stores (``batch.py:473-479``): the port follows the kernel on both devices
(ROADMAP, declared differences).
"""

from __future__ import annotations

from typing import Optional

import torch

from visual_rag_tpu_torch.ops.kernels import _build
from visual_rag_tpu_torch.ops.kernels._checks import (
    DTYPE_CODES,
    check_scales,
    check_store,
    compute_dtype,
    on_cpu,
    ptr,
    stream_ptr,
)

NEG_INF = -1e30
_MAX_SMEM_BYTES = 200 * 1024  # the f32 query tile; a block may hold 227 KB
_GATHER_BUDGET_BYTES = 256 * 1024 * 1024  # f32 doc windows per chunk


def rerank_candidates(
    flat: torch.Tensor,  # [N + pad, dim] ragged store (f32/bf16/f16/int8 codes)
    offsets: torch.Tensor,  # [D] int32
    lengths: torch.Tensor,  # [D] int32
    queries: torch.Tensor,  # [B, NQ, dim] l2-normalised tokens
    qmask: torch.Tensor,  # [B, NQ] 0/1 (bool or float)
    candidates: torch.Tensor,  # [B, K] doc ids, -1 = padding
    max_len: int,
    doc_scales: Optional[torch.Tensor] = None,  # [D] f32 per-doc scales
) -> torch.Tensor:
    """Exact MaxSim scores [B, K] f32 of each query's candidate docs."""
    if on_cpu(flat):
        return rerank_candidates_ref(flat, offsets, lengths, queries, qmask,
                                     candidates, max_len, doc_scales)
    check_store(flat, offsets, lengths)
    if queries.dim() != 3 or queries.shape[2] != flat.shape[1]:
        raise ValueError(f"queries must be [B, NQ, {flat.shape[1]}], got {tuple(queries.shape)}")
    b, nq, dim = queries.shape
    if tuple(qmask.shape) != (b, nq):
        raise ValueError(f"qmask must be [{b}, {nq}], got {tuple(qmask.shape)}")
    if candidates.dim() != 2 or candidates.shape[0] != b:
        raise ValueError(f"candidates must be [{b}, K], got {tuple(candidates.shape)}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit of 65535 queries")
    tq = min(32, max(8, -(-nq // 8) * 8))  # csrc tile_rows()
    if -(-nq // tq) * tq * dim * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"query of {nq} tokens does not fit the kernel's shared-memory tile")
    for name, t in (("queries", queries), ("qmask", qmask), ("candidates", candidates)):
        if t.device != flat.device:
            raise ValueError(f"{name} is on {t.device}, the store on {flat.device}")
    check_scales(doc_scales, flat, offsets)
    k = candidates.shape[1]
    q = queries.to(compute_dtype(flat.dtype)).contiguous()  # as on the TPU
    if q.data_ptr() % 16:
        raise ValueError("queries must start 16-byte aligned")
    qm = qmask.to(torch.float32).contiguous()
    cand = candidates.to(torch.int32).contiguous()
    out = torch.empty((b, k), dtype=torch.float32, device=flat.device)
    if b == 0 or k == 0:
        return out
    lib = _build.load_library()
    err = lib.vrt_rerank_candidates(
        flat.device.index, ptr(flat), DTYPE_CODES[flat.dtype], ptr(offsets), ptr(lengths),
        ptr(doc_scales), b, nq, dim, ptr(q), DTYPE_CODES[q.dtype], ptr(qm), k,
        offsets.shape[0], ptr(cand),
        ptr(out), stream_ptr(flat.device))
    _build.check(err, "rerank_candidates launch")
    rerank_candidates.launches += 1
    return out


rerank_candidates.launches = 0


def rerank_candidates_ref(flat, offsets, lengths, queries, qmask, candidates,
                          max_len: int, doc_scales=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rerank_candidates`: gather each
    candidate's ``max_len``-row window, chunked over K to bound the f32
    gather, then mask rows ``>= len``, take the max per query token and the
    qmask-weighted sum, times the doc's scale. Queries are rounded as the
    kernel rounds them, then all math is f32."""
    b, k = candidates.shape
    dev = flat.device
    dim = flat.shape[1]
    q = queries.to(compute_dtype(flat.dtype)).float()
    qm = qmask.float()
    cand = candidates.long()
    valid = cand >= 0
    safe = cand.clamp(min=0)
    offs = offsets.long()[safe]
    lens = torch.where(valid, lengths.long()[safe], 0)
    ar = torch.arange(max(1, int(max_len)), device=dev)
    per_cand = max(1, b * ar.numel() * dim * 4)
    chunk = max(1, min(k, _GATHER_BUDGET_BYTES // per_cand))
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    for s in range(0, k, chunk):
        o, ln = offs[:, s:s + chunk], lens[:, s:s + chunk]
        idx = (o[..., None] + ar).clamp(max=flat.shape[0] - 1)  # [B, c, T]
        docs = flat[idx].float()  # [B, c, T, dim]
        sims = torch.einsum("bqd,bktd->bkqt", q, docs)
        rows = (ar < ln[..., None])[:, :, None, :]
        per_q = sims.masked_fill(~rows, NEG_INF).amax(dim=-1)  # [B, c, NQ]
        out[:, s:s + chunk] = (per_q * qm[:, None, :]).sum(dim=-1)
    if doc_scales is not None:
        out = out * doc_scales.float()[safe]
    return torch.where(valid & (lens > 0), out, NEG_INF)
