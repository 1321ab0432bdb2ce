"""The stage-1 kernels over the P-leading pooled store: query token rows (K5,
K6, K7) or one pooled query vector (the pooled stage-1) against every doc's
pooled rows.

Port of ``visual_rag_tpu/ops/kernels/prefetch_topk.py``. Its three Pallas
kernels compute one function and differ only in how the TPU grid walks the
queries, so here they are three entry points of one hand-written CUDA
kernel, ``csrc/pooled_maxsim.cu``, each with its own launch counter:

- :func:`pooled_maxsim_scores_packed` (K5, ``:172-227``): the group-packed
  wire, queries ``[G * Rg, dim]`` with their in-group owners ``qid``;
- :func:`pooled_maxsim_scores_qbatch` (K6, ``:263-329``): the padded wire,
  tokens ``[B, NQ, dim]`` and ``qmask``;
- :func:`pooled_maxsim_scores` (K7, ``:332-374``): the same one query per
  call on the TPU grid; here the same launch as K6.

K6 and K7 map the padded batch onto the packed form with one query per
group (as ``retrieval/local.py`` does for the scan). On a CPU tensor each
entry point runs the plain PyTorch version
:func:`pooled_maxsim_scores_packed_ref`, ported from the XLA fallbacks
``visual_rag_tpu/parallel/sharded.py:308-338`` and ``:533-573``; on a CUDA
tensor it launches the kernel or raises.

Semantics: ``out[b, d] = sum over b's rows m of w[m] * max over valid p of
scale[p, d] * (q[m] . vals[p, d])``; a doc with no valid pooled row gives 0
per row (not ``NEG_INF``, unlike the MaxSim kernels). Two bodies, each
entry point counting its launches of each:

- ``launches``: queries rounded to the store dtype (bf16 for int8 codes),
  products exact in f32, the per-row scale on each similarity before the
  max over P (``prefetch_topk.py:106``, ``:156``);
- ``launches_qdot`` (``qdot_int8=True``, int8 stores; the engine's choice
  for a prefetch stage-1): query rows quantized to int8, integer dots, and
  each row's query scale folded into its weight ``w`` (``:204-207``). This
  is also the function of the A/B prototype
  ``scripts/tpu_tokens_qdot_ab.py::main.make_v2`` (K9). The integer dots are
  exact in both versions, so the per-row maxima agree bit for bit.

:func:`pooled_stage1_scores`, the pooled stage-1 (``csrc/pooled_stage1.cu``),
replaces no TPU kernel: the JAX package leaves it to XLA
(``visual_rag_tpu/parallel/sharded.py:341-351``), an einsum, a where and a
max that XLA fuses on the TPU and that run as separate passes through
device memory in plain PyTorch. The kernel is that fusion on the tensor
cores; at the benchmark's shape (1024 queries, 200k docs, P 32, dim 128) a
call is 1.68 TFLOP against a 1.64 GB store, so operations bound it, and it
keeps each tile's scores in registers, masks them and takes the max over P
before anything reaches memory (the source says how). It is built for rows
of 128; at any other width the wrapper launches K6 with each pooled query as
a one-row query, which is the same function on the CUDA cores. On a CPU
tensor it runs :func:`pooled_stage1_scores_ref`, the plain loop; f32 stores
take that loop on the card too (``retrieval/local.py``), since the tensor
cores would need TF32 for them.
"""

from __future__ import annotations

from typing import Optional

import torch

from visual_rag_tpu_torch.ops.kernels import _build
from visual_rag_tpu_torch.ops.kernels._checks import (
    DTYPE_CODES,
    NEG_INF,
    compute_dtype,
    on_cpu,
    ptr,
    stream_ptr,
)
from visual_rag_tpu_torch.ops.kernels.maxsim_scan import quantize_queries_int8

_SIMS_BUDGET_BYTES = 256 * 1024 * 1024  # f32 [M, P, chunk] similarity tile per doc chunk
_MAX_SMEM_BYTES = 227 * 1024  # shared memory one block may use on the H100
_DOCS_PER_BLOCK = 64  # csrc PM_BD
_ROW_THREADS = 16  # csrc PM_TY
_STAGE1_DIM = 128  # csrc PS_DIM


def pooled_maxsim_scores_packed(
    vals_t: torch.Tensor,  # [P, D, dim] P-leading pooled store (f32/bf16/f16/int8 codes)
    mask_t: torch.Tensor,  # [P, D] bool row validity
    qpacked: torch.Tensor,  # [G * Rg, dim] l2-normalised packed query rows
    qid: torch.Tensor,  # [G, Rg] int32 in-group owner (-1 = pad row)
    b: int,  # batch size (G * gq)
    w: Optional[torch.Tensor] = None,  # [G * Rg] f32 row weights (default: qid >= 0)
    scales_t: Optional[torch.Tensor] = None,  # [P, D] f32 per-row scales
    qdot_int8: bool = False,  # int8 store: int8 queries, integer dots
) -> torch.Tensor:
    """Group-packed stage-1 scores [B, D] f32 (K5; K9 under ``qdot_int8``)."""
    if w is None:
        w = (qid >= 0).to(torch.float32).reshape(-1)
    return _run(pooled_maxsim_scores_packed, vals_t, mask_t, qpacked, qid, b, w, scales_t,
                qdot_int8)


def pooled_maxsim_scores_qbatch(vals_t, mask_t, queries, qmask, scales_t=None,
                                qdot_int8: bool = False) -> torch.Tensor:
    """Padded-wire stage-1 scores [B, D] f32 (K6): ``queries`` [B, NQ, dim],
    ``qmask`` [B, NQ] weights (0 = pad token)."""
    return _run(pooled_maxsim_scores_qbatch, vals_t, mask_t,
                *_as_packed(vals_t, queries, qmask), scales_t, qdot_int8)


def pooled_maxsim_scores(vals_t, mask_t, queries, qmask, scales_t=None,
                         qdot_int8: bool = False) -> torch.Tensor:
    """Per-query stage-1 scores [B, D] f32 (K7): K6's function, the entry
    point of a batch of single queries (the engine's ``search_embedded``).
    The TPU's K7 has no qdot form; here a batch of one that the engine sends
    qdot goes through this entry point as through K6."""
    return _run(pooled_maxsim_scores, vals_t, mask_t, *_as_packed(vals_t, queries, qmask),
                scales_t, qdot_int8)


for _fn in (pooled_maxsim_scores_packed, pooled_maxsim_scores_qbatch, pooled_maxsim_scores):
    _fn.launches = 0
    _fn.launches_qdot = 0


def _run(entry, vals_t, mask_t, qpacked, qid, b, w, scales_t, qdot_int8):
    """The plain version for a CPU store, else the kernel, counted on ``entry``."""
    if qdot_int8 and vals_t.dtype != torch.int8:
        raise ValueError("qdot_int8 requires an int8 store")
    if on_cpu(vals_t):
        return pooled_maxsim_scores_packed_ref(vals_t, mask_t, qpacked, qid, b, w, scales_t,
                                               qdot_int8)
    out = _launch(vals_t, mask_t, qpacked, qid, b, w, scales_t, qdot_int8)
    if qdot_int8:
        entry.launches_qdot += 1
    else:
        entry.launches += 1
    return out


def _query_rows(vals_t, qpacked, w, qdot_int8):
    """(query rows as the kernel reads them, row weights): int8 codes and
    ``w`` times each row's scale under ``qdot_int8``, else the rows rounded
    to the store's compute dtype and ``w`` itself."""
    if qdot_int8:
        codes, qs = quantize_queries_int8(qpacked)
        return codes, w.float() * qs
    return qpacked.to(compute_dtype(vals_t.dtype)), w.float()


def _as_packed(vals_t, queries, qmask):
    """Padded [B, NQ, dim] tokens as the packed form with one query per
    group: group i is query i's NQ rows, owned where qmask is non-zero and
    weighted by qmask. Returns (qpacked, qid, b, w)."""
    if queries.dim() != 3 or tuple(qmask.shape) != tuple(queries.shape[:2]):
        raise ValueError(f"queries must be [B, NQ, dim] and qmask [B, NQ], got "
                         f"{tuple(queries.shape)} and {tuple(qmask.shape)}")
    b, nq, dim = queries.shape
    qid = torch.where(qmask != 0, 0, -1).to(torch.int32)
    return queries.reshape(b * nq, dim), qid, b, qmask.to(torch.float32).reshape(-1)


def rows_per_thread(rg: int) -> int:
    """Query rows each thread of the kernel holds (csrc ``RM``): a chunk of
    16 * RM rows covers the group, up to 128 rows."""
    return next((rm for rm in (1, 2, 4) if rg <= _ROW_THREADS * rm), 8)


def smem_bytes(rg: int, dim: int, gq: int, qdot: bool = False) -> int:
    """Shared memory of one block (csrc ``pooled_smem_floats``): rows of
    ``dim`` f32, or of ``dim / 4`` words of packed int8 codes for qdot."""
    bm, ld = _ROW_THREADS * rows_per_thread(rg), (dim // 4 if qdot else dim) + 4
    v = max(_DOCS_PER_BLOCK * ld, bm * _DOCS_PER_BLOCK)
    return 4 * (bm * ld + v + gq * _DOCS_PER_BLOCK + 2 * bm + 3 * _DOCS_PER_BLOCK)


def _launch(vals_t, mask_t, qpacked, qid, b, w, scales_t, qdot_int8) -> torch.Tensor:
    """Check what the kernel takes, then launch it; raises on anything else."""
    if vals_t.dtype not in DTYPE_CODES:
        raise ValueError(f"store dtype {vals_t.dtype} not supported by the kernel "
                         "(float32, bfloat16, float16, int8)")
    if vals_t.dim() != 3 or not vals_t.is_contiguous():
        raise ValueError("vals_t must be a contiguous [P, D, dim] tensor")
    p, d, dim = vals_t.shape
    step = 16 if qdot_int8 else 8  # elements a thread loads at once
    if dim % step or vals_t.data_ptr() % 16:
        raise ValueError(f"vals_t rows must be 16-byte aligned: dim % {step} == 0 and an "
                         "aligned base")
    if tuple(mask_t.shape) != (p, d):
        raise ValueError(f"mask_t must be [{p}, {d}], got {tuple(mask_t.shape)}")
    if qid.dim() != 2:
        raise ValueError(f"qid must be [G, Rg], got {tuple(qid.shape)}")
    g, rg = qid.shape
    if tuple(qpacked.shape) != (g * rg, dim):
        raise ValueError(f"qpacked must be [{g * rg}, {dim}], got {tuple(qpacked.shape)}")
    if tuple(w.shape) != (g * rg,):
        raise ValueError(f"w must be [{g * rg}], got {tuple(w.shape)}")
    if g == 0 or b % g:
        raise ValueError(f"batch {b} is not a multiple of the {g} query groups")
    gq = b // g
    if -(-d // _DOCS_PER_BLOCK) > 65535:
        raise ValueError(f"{d} docs exceed the kernel's grid limit of "
                         f"{65535 * _DOCS_PER_BLOCK}")
    if smem_bytes(rg, dim, gq, qdot_int8) > _MAX_SMEM_BYTES:
        raise ValueError(f"{gq} queries a group of dim {dim} do not fit the kernel's "
                         "shared memory")
    if scales_t is not None and (scales_t.dtype != torch.float32
                                 or tuple(scales_t.shape) != (p, d)):
        raise ValueError(f"scales_t must be a float32 [{p}, {d}] tensor")
    for name, t in (("mask_t", mask_t), ("qpacked", qpacked), ("qid", qid), ("w", w),
                    ("scales_t", scales_t)):
        if t is not None and t.device != vals_t.device:
            raise ValueError(f"{name} is on {t.device}, the store on {vals_t.device}")
    q, wt = _query_rows(vals_t, qpacked, w, qdot_int8)
    q, wt = q.contiguous(), wt.contiguous()
    if q.data_ptr() % 16:
        raise ValueError("qpacked must start 16-byte aligned")
    m = mask_t.to(torch.bool).contiguous()
    qi = qid.to(torch.int32).contiguous()
    sc = None if scales_t is None else scales_t.contiguous()
    out = torch.empty((b, d), dtype=torch.float32, device=vals_t.device)
    if d == 0:
        return out
    lib = _build.load_library()
    err = lib.vrt_pooled_maxsim_scores_packed(
        vals_t.device.index, ptr(vals_t), DTYPE_CODES[vals_t.dtype], ptr(m), ptr(sc), p, d,
        ptr(q), DTYPE_CODES[q.dtype], g, rg, gq, dim, rows_per_thread(rg), ptr(qi), ptr(wt),
        ptr(out), stream_ptr(vals_t.device))
    _build.check(err, "pooled_maxsim_scores launch")
    return out


def pooled_stage1_scores(
    vals_t: torch.Tensor,  # [P, D, dim] P-leading pooled store (bf16/f16/int8 codes)
    mask_t: torch.Tensor,  # [P, D] bool row validity
    pooled: torch.Tensor,  # [B, dim] pooled query vectors
    scales_t: Optional[torch.Tensor] = None,  # [P, D] f32 per-row scales
) -> torch.Tensor:
    """[B, D] f32: the max over each doc's valid pooled rows of the pooled
    query's dot, times the row's scale; 0 for a doc with no valid row. The
    plain version on a CPU store; on the card the kernel, counted on
    ``.launches``, or K6 at rows other than 128 wide, counted on K6's."""
    if on_cpu(vals_t):
        return pooled_stage1_scores_ref(vals_t, mask_t, pooled, scales_t)
    if vals_t.dtype not in (torch.bfloat16, torch.float16, torch.int8):
        raise ValueError(f"store dtype {vals_t.dtype} not supported by the pooled stage-1 "
                         "kernel (bfloat16, float16, int8); float32 stores take "
                         "pooled_stage1_scores_ref")
    if vals_t.shape[-1] != _STAGE1_DIM:
        ones = torch.ones((pooled.shape[0], 1), dtype=torch.float32, device=pooled.device)
        return pooled_maxsim_scores_qbatch(vals_t, mask_t, pooled[:, None], ones, scales_t)
    out = _launch_stage1(vals_t, mask_t, pooled, scales_t)
    pooled_stage1_scores.launches += 1
    return out


pooled_stage1_scores.launches = 0


def _launch_stage1(vals_t, mask_t, pooled, scales_t) -> torch.Tensor:
    """Check what the pooled stage-1 kernel takes, then launch it; raises on
    anything else."""
    if vals_t.dim() != 3 or not vals_t.is_contiguous() or vals_t.data_ptr() % 16:
        raise ValueError("vals_t must be a contiguous, 16-byte aligned [P, D, dim] tensor")
    p, d, dim = vals_t.shape
    if p == 0 or tuple(mask_t.shape) != (p, d):
        raise ValueError(f"mask_t must be [{p}, {d}] with P > 0, got {tuple(mask_t.shape)}")
    if pooled.dim() != 2 or pooled.shape[1] != dim:
        raise ValueError(f"pooled must be [B, {dim}], got {tuple(pooled.shape)}")
    if scales_t is not None and (scales_t.dtype != torch.float32
                                 or tuple(scales_t.shape) != (p, d)):
        raise ValueError(f"scales_t must be a float32 [{p}, {d}] tensor")
    for name, t in (("mask_t", mask_t), ("pooled", pooled), ("scales_t", scales_t)):
        if t is not None and t.device != vals_t.device:
            raise ValueError(f"{name} is on {t.device}, the store on {vals_t.device}")
    q = pooled.to(compute_dtype(vals_t.dtype)).contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    m = mask_t.to(torch.bool).contiguous()
    if m.data_ptr() % 4:
        m = m.clone()
    sc = None if scales_t is None else scales_t.contiguous()
    b = q.shape[0]
    out = torch.empty((b, d), dtype=torch.float32, device=vals_t.device)
    if b == 0 or d == 0:
        return out
    err = _build.load_library().vrt_pooled_stage1_scores(
        vals_t.device.index, ptr(vals_t), DTYPE_CODES[vals_t.dtype], ptr(m), ptr(sc), p, d,
        dim, ptr(q), b, ptr(out), stream_ptr(vals_t.device))
    _build.check(err, "pooled_stage1_scores launch")
    return out


def pooled_stage1_scores_ref(vals_t, mask_t, pooled, scales_t=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`pooled_stage1_scores`, the JAX
    package's ``_local_pooled_padded``. The query is rounded to the store's
    compute dtype (bf16 for int8 codes), then the product is f32, times the
    row's scale, before the max; one ``torch.matmul`` per pooled row with a
    running max bounds the transient to one [B, D] tile."""
    q = pooled.to(compute_dtype(vals_t.dtype)).float()
    out = None
    for p in range(vals_t.shape[0]):
        s = q @ vals_t[p].float().T
        if scales_t is not None:
            s = s * scales_t[p][None, :]
        s = s.masked_fill(~mask_t[p].bool()[None, :], NEG_INF)
        out = s if out is None else torch.maximum(out, s)
    return torch.where(mask_t.bool().any(dim=0)[None, :], out, 0.0)


def pooled_maxsim_scores_packed_ref(vals_t, mask_t, qpacked, qid, b: int, w=None,
                                    scales_t=None, qdot_int8: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the three entry points, on the packed form.

    Per chunk of docs: one [M, dim] x [dim, P * chunk] product of every
    query row with every pooled row, scaled, masked to ``NEG_INF`` where a
    row is invalid, the max over P, 0 for docs with no valid row, then a
    [gq, Rg] weighted-ownership product per group sums each query's rows.
    The chunk keeps the f32 [M, P, chunk] tile under a fixed budget. Under
    ``qdot_int8`` the product is of int8 codes, exact in f32."""
    p, d, dim = vals_t.shape
    g, rg = qid.shape
    gq = b // g
    dev = vals_t.device
    if w is None:
        w = (qid >= 0).to(torch.float32).reshape(-1)
    q, w = _query_rows(vals_t, qpacked, w, qdot_int8)
    q = q.float()  # [M, dim]
    own = qid.long()[:, None, :] == torch.arange(gq, device=dev)[None, :, None]
    seg = own.float() * w.reshape(g, 1, rg)  # [G, gq, Rg]
    mask = mask_t.bool()
    per_doc = max(1, q.shape[0] * p * 4)
    chunk = max(1, min(max(d, 1), _SIMS_BUDGET_BYTES // per_doc))
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    for s in range(0, d, chunk):
        v = vals_t[:, s:s + chunk].float()  # [P, c, dim]
        c = v.shape[1]
        sims = (q @ v.reshape(p * c, dim).T).reshape(-1, p, c)  # [M, P, c]
        if scales_t is not None:
            sims = sims * scales_t[:, s:s + chunk].float()[None]
        m = mask[:, s:s + chunk]
        per_row = sims.masked_fill(~m[None], NEG_INF).amax(dim=1)  # [M, c]
        per_row = torch.where(m.any(dim=0)[None, :], per_row, 0.0)
        out[:, s:s + chunk] = torch.bmm(seg, per_row.reshape(g, rg, c)).reshape(b, c)
    return out
