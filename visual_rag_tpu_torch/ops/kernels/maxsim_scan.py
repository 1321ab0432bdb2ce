"""Exhaustive MaxSim scan: every doc scored against the whole query batch.

Port of ``visual_rag_tpu/ops/kernels/maxsim_scan.py:50-257``
(``quantize_queries_int8``, ``exhaustive_scores_packed``) for float and int8
stores. On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/maxsim_scan.cu``; on a CPU tensor it runs the plain PyTorch version
:func:`exhaustive_scores_packed_ref`, ported from
``visual_rag_tpu/retrieval/batch.py:355-432`` (``xla_exhaustive_packed``,
chunked over docs). Empty docs score ``NEG_INF`` (TPU kernel ``:256-257``).

Two bodies, each with its own launch counter:

- ``launches``: queries rounded to the store dtype (bf16 for int8 codes),
  products exact in f32, per-doc scales on each row max before the
  per-query sum (TPU kernel ``:148``);
- ``launches_qdot`` (``qdot_int8=True``, int8 stores only; the engine's
  choice on ``int8_refined``): queries quantized per row to int8
  (:func:`quantize_queries_int8`), integer dots, and each row's query scale
  folded into its ownership weight (``:155-156``). The integer dots are
  exact in both versions (|dot| <= 127 * 127 * dim < 2**24 at dim 128), so
  the per-row maxima agree bit for bit.

The kernel sums each query's rows in a fixed order, so two calls on the
same inputs give bit-equal scores: the strict oracle relies on it.
"""

from __future__ import annotations

from typing import Optional

import torch

from visual_rag_tpu_torch.ops.kernels import _build
from visual_rag_tpu_torch.ops.kernels._checks import (
    DTYPE_CODES,
    NEG_INF,
    check_scales,
    check_store,
    compute_dtype,
    on_cpu,
    ptr,
    stream_ptr,
)

_SIMS_BUDGET_BYTES = 256 * 1024 * 1024  # f32 similarity tile per doc chunk


def quantize_queries_int8(qpacked: torch.Tensor):
    """Per-row symmetric int8 of query rows: (codes int8 [M, dim], scales f32
    [M]) with ``codes[r] * scales[r] ~= qpacked[r]``. ``torch.round`` rounds
    half to even, as ``jnp.round`` does. Scales are positive, so they
    commute with every max over doc rows and fold into the row weights."""
    q = qpacked.float()
    s = (q.abs().amax(dim=1, keepdim=True) / 127.0).clamp(min=1e-12)
    codes = torch.round(q / s).clamp(-127.0, 127.0).to(torch.int8)
    return codes, s[:, 0]


def exhaustive_scores_packed(
    flat: torch.Tensor,  # [N + pad, dim] ragged store (f32/bf16/f16/int8 codes)
    offsets: torch.Tensor,  # [D] int32
    lengths: torch.Tensor,  # [D] int32
    qpacked: torch.Tensor,  # [G * Rg, dim] l2-normalised packed query tokens
    qid: torch.Tensor,  # [G, Rg] int32 in-group owner (-1 = pad row)
    max_len: int,
    b: int,  # batch size (G * gq)
    doc_scales: Optional[torch.Tensor] = None,  # [D] f32 per-doc scales
    qdot_int8: bool = False,  # int8 store: int8 queries, integer dots
) -> torch.Tensor:
    """Exact MaxSim scores [B, D] f32 of every query against every doc."""
    if qdot_int8 and flat.dtype != torch.int8:
        raise ValueError("qdot_int8 requires an int8 store")
    if on_cpu(flat):
        return exhaustive_scores_packed_ref(flat, offsets, lengths, qpacked, qid,
                                            max_len, b, doc_scales, qdot_int8)
    check_store(flat, offsets, lengths)
    if qid.dim() != 2:
        raise ValueError(f"qid must be [G, Rg], got {tuple(qid.shape)}")
    g, rg = qid.shape
    dim = flat.shape[1]
    if tuple(qpacked.shape) != (g * rg, dim):
        raise ValueError(f"qpacked must be [{g * rg}, {dim}], got {tuple(qpacked.shape)}")
    if g == 0 or b % g:
        raise ValueError(f"batch {b} is not a multiple of the {g} query groups")
    if g > 65535:
        raise ValueError(f"{g} query groups exceed the kernel's grid limit of 65535")
    for name, t in (("qpacked", qpacked), ("qid", qid)):
        if t.device != flat.device:
            raise ValueError(f"{name} is on {t.device}, the store on {flat.device}")
    check_scales(doc_scales, flat, offsets)
    d = offsets.shape[0]
    w = None
    if qdot_int8:
        q, w = quantize_queries_int8(qpacked)
    else:
        q = qpacked.to(compute_dtype(flat.dtype))
    q = q.contiguous()
    if q.data_ptr() % 16:
        raise ValueError("qpacked must start 16-byte aligned")
    qi = qid.to(torch.int32).contiguous()
    out = torch.empty((b, d), dtype=torch.float32, device=flat.device)
    if d == 0:
        return out
    lib = _build.load_library()
    err = lib.vrt_exhaustive_scores_packed(
        flat.device.index, ptr(flat), DTYPE_CODES[flat.dtype], ptr(offsets), ptr(lengths), d,
        ptr(doc_scales), ptr(q), DTYPE_CODES[q.dtype], ptr(w), g, rg, b // g, dim, ptr(qi),
        ptr(out), stream_ptr(flat.device))
    _build.check(err, "exhaustive_scores_packed launch")
    if qdot_int8:
        exhaustive_scores_packed.launches_qdot += 1
    else:
        exhaustive_scores_packed.launches += 1
    return out


exhaustive_scores_packed.launches = 0
exhaustive_scores_packed.launches_qdot = 0


def exhaustive_scores_packed_ref(flat, offsets, lengths, qpacked, qid, max_len: int,
                                 b: int, doc_scales=None,
                                 qdot_int8: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`exhaustive_scores_packed`, doc-major:
    each chunk of docs is gathered once as ``max_len``-row windows and
    scored against every packed row in one matmul; rows ``>= len`` are
    masked, the max is taken per packed row and scaled by its doc's scale,
    and a [gq, Rg] ownership matmul per group (weighted by the query scales
    under ``qdot_int8``) sums each query's rows. All math is f32."""
    g, rg = qid.shape
    gq = b // g
    dev = flat.device
    d = offsets.shape[0]
    seg = (qid.long()[:, None, :] == torch.arange(gq, device=dev)[None, :, None]).float()
    if qdot_int8:
        codes, qs = quantize_queries_int8(qpacked)
        q = codes.float()  # integer dots below are exact in f32
        seg = seg * qs.reshape(g, 1, rg)
    else:
        q = qpacked.to(compute_dtype(flat.dtype)).float()  # [M, dim]
    ar = torch.arange(max(1, int(max_len)), device=dev)
    per_doc = max(1, q.shape[0] * ar.numel() * 4)
    chunk = max(1, min(max(d, 1), _SIMS_BUDGET_BYTES // per_doc))
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    for s in range(0, d, chunk):
        offs = offsets[s:s + chunk].long()
        lens = lengths[s:s + chunk].long()
        c = offs.shape[0]
        idx = (offs[:, None] + ar).clamp(max=flat.shape[0] - 1)  # [c, T]
        docs = flat[idx].float().reshape(c * ar.numel(), -1)
        sims = (q @ docs.T).reshape(-1, c, ar.numel())  # [M, c, T]
        sims = sims.masked_fill(~(ar < lens[:, None])[None], NEG_INF)
        has = lens > 0
        per_tok = torch.where(has[None, :], sims.amax(dim=-1), 0.0)  # [M, c]
        if doc_scales is not None:
            per_tok = per_tok * doc_scales[s:s + chunk].float()[None, :]
        res = torch.bmm(seg, per_tok.reshape(g, rg, c)).reshape(b, c)
        out[:, s:s + chunk] = torch.where(has[None, :], res, NEG_INF)
    return out
