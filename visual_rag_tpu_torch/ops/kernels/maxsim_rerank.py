"""Stage-2 rerank: exact MaxSim of each query against its own K candidates.

Port of ``visual_rag_tpu/ops/kernels/maxsim_rerank.py``: K2
``rerank_candidates`` (``:95-181``) and K3 ``rerank_candidates_dedup``
(``:271-372``), for float and int8 stores. On a CUDA tensor each wrapper
launches its hand-written kernel (``csrc/maxsim_rerank.cu``; K3: the
tensor-core body ``csrc/maxsim_dedup_mma.cu`` for bf16, f16 and int8 stores
at dim 128, ``csrc/maxsim_dedup.cu`` for the others); on a CPU tensor it
runs its plain PyTorch version. K2's, :func:`rerank_candidates_ref`, is ported from
``visual_rag_tpu/retrieval/batch.py:474-508`` (``xla_rerank_batch``) and
scores the pairs in place; K3's, :func:`rerank_candidates_dedup_ref`, runs
K3's own bookkeeping (:func:`dedup_layout`) and scores the sorted pairs.
Both score through :func:`pair_scores`, in f32, chunked over the pairs. All
score -1 candidates and 0-token docs ``NEG_INF``, as the TPU kernels do
(``:177-181``, ``:370-372``).

Queries are rounded to the store dtype, and to bf16 for int8 codes, as the
TPU kernels round them (``:171``, ``:362``); the per-doc scale multiplies
the finished score (``:89``, ``:266``). The JAX package's XLA fallback keeps
f32 queries on int8 stores (``batch.py:473-479``): the port follows the
kernels on both devices (ROADMAP, declared differences).
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

_MAX_SMEM_BYTES = 200 * 1024  # K2's f32 query tile; a block may hold 227 KB
_PAIR_SMEM_BYTES = 227 * 1024  # all of K3's and K4's block (csrc/maxsim_pairs.cuh)
_GATHER_BUDGET_BYTES = 256 * 1024 * 1024  # f32 doc windows per chunk
RUN_PAIRS = 16  # pairs of one doc per K3 block (csrc/maxsim_pairs.cuh GROUP)
MMA_DIM = 128  # the row width of K3's tensor-core body (csrc/maxsim_dedup_mma.cu)
MMA_QTILES = 24  # 16-row query tiles of one run in that body (DM_QTILES)


def _tile_rows(nq: int) -> int:
    """Query rows per kernel tile (csrc/maxsim_common.cuh tile_rows)."""
    return min(32, max(8, -(-nq // 8) * 8))


def pair_smem_bytes(itemsize: int, dim: int, nq: int) -> int:
    """Shared memory of one K3/K4 block (csrc/maxsim_pairs.cuh
    ``pair_smem_bytes``): a 128-row tile of the store in its dtype, each row
    padded by one load unit, the f32 query, the reduction scratch, the
    running maxima and the metadata of 16 pairs."""
    tq = _tile_rows(nq)
    nq_pad = -(-nq // tq) * tq
    stride = dim * itemsize + (8 if itemsize == 1 else 16)
    return 128 * stride + 4 * (nq_pad * dim + 4 * tq + 16 * nq_pad + 16) + 4 * 4 * 16


def pair_kernels_fit(itemsize: int, dim: int, nq: int) -> bool:
    """Whether K3 and K4 take a query of ``nq`` tokens over a store of this
    row width: the CUDA kernels' own envelope (the TPU's VMEM and SMEM
    budgets do not carry over)."""
    return dim % 8 == 0 and pair_smem_bytes(itemsize, dim, nq) <= _PAIR_SMEM_BYTES


def check_rerank_args(flat, offsets, lengths, queries, qmask, candidates, doc_scales):
    """Checks shared by the CUDA rerank wrappers (K2, K3, K4); returns the
    kernel-ready (queries in their rounding dtype, f32 qmask, int32
    candidates)."""
    check_store(flat, offsets, lengths)
    if queries.dim() != 3 or queries.shape[2] != flat.shape[1]:
        raise ValueError(f"queries must be [B, NQ, {flat.shape[1]}], got {tuple(queries.shape)}")
    b, nq, _ = queries.shape
    if tuple(qmask.shape) != (b, nq):
        raise ValueError(f"qmask must be [{b}, {nq}], got {tuple(qmask.shape)}")
    if candidates.dim() != 2 or candidates.shape[0] != b:
        raise ValueError(f"candidates must be [{b}, K], got {tuple(candidates.shape)}")
    if candidates.numel() >= 2**31:
        raise ValueError(f"{candidates.numel()} candidates exceed the kernels' int32 indexing")
    for name, t in (("queries", queries), ("qmask", qmask), ("candidates", candidates)):
        if t.device != flat.device:
            raise ValueError(f"{name} is on {t.device}, the store on {flat.device}")
    check_scales(doc_scales, flat, offsets)
    q = queries.to(compute_dtype(flat.dtype)).contiguous()  # as on the TPU
    if q.data_ptr() % 16:
        raise ValueError("queries must start 16-byte aligned")
    return q, qmask.to(torch.float32).contiguous(), candidates.to(torch.int32).contiguous()


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
    q, qm, cand = check_rerank_args(flat, offsets, lengths, queries, qmask, candidates,
                                    doc_scales)
    (b, nq, dim), k = queries.shape, candidates.shape[1]
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit of 65535 queries")
    tq = _tile_rows(nq)
    if -(-nq // tq) * tq * dim * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"query of {nq} tokens does not fit the kernel's shared-memory tile")
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
    """Plain PyTorch version of :func:`rerank_candidates`: the
    :func:`pair_scores` of every (query, candidate) pair in place, pair
    ``b * K + k`` being query ``b`` against the window of
    ``candidates[b, k]``."""
    b, k = candidates.shape
    cand = candidates.reshape(-1).long()
    safe = cand.clamp(min=0)
    lens = torch.where(cand >= 0, lengths.long()[safe], 0)
    qid = torch.arange(b * k, device=flat.device) // max(1, k)
    scales = None if doc_scales is None else doc_scales[safe]
    return pair_scores(flat, offsets[safe], lens, queries, qmask, qid, max_len,
                       scales).view(b, k)


def pair_scores(flat, row0, lens, queries, qmask, qid, max_len: int,
                scales=None) -> torch.Tensor:
    """[N] f32 MaxSim of N (query, window) pairs, the plain scorer of K2 and
    of the pair-sorted kernels' layouts (K3, K4): pair i scores query ``qid[i]``
    against rows ``[row0[i], row0[i] + lens[i])`` of ``flat``, times
    ``scales[i]``, ``NEG_INF`` where ``lens[i] == 0``. Queries are rounded as
    the kernels round them, then all math is f32, chunked over the pairs to
    bound the gather."""
    dev, dim = flat.device, flat.shape[1]
    q = queries.to(compute_dtype(flat.dtype)).float()
    qm = qmask.float()
    qid, row0, lens = qid.long(), row0.long(), lens.long()
    ar = torch.arange(max(1, int(max_len)), device=dev)
    chunk = max(1, _GATHER_BUDGET_BYTES // (ar.numel() * dim * 4))
    out = torch.empty(qid.shape, dtype=torch.float32, device=dev)
    for s in range(0, qid.numel(), chunk):
        qi, ln = qid[s:s + chunk], lens[s:s + chunk]
        idx = (row0[s:s + chunk, None] + ar).clamp(0, flat.shape[0] - 1)  # [c, T]
        sims = torch.einsum("cqd,ctd->cqt", q[qi], flat[idx].float())
        rows = (ar < ln[:, None])[:, None, :]
        per_q = sims.masked_fill(~rows, NEG_INF).amax(dim=-1)  # [c, NQ]
        out[s:s + chunk] = (per_q * qm[qi]).sum(dim=-1)
    if scales is not None:
        out = out * scales.float()
    return torch.where(lens > 0, out, NEG_INF)


def uses_mma(dtype: torch.dtype, dim: int) -> bool:
    """Whether K3 on a CUDA store of this dtype and row width runs its
    tensor-core body: bf16, f16 and int8 codes at dim 128. f32 stores and
    other widths keep the CUDA-core body (TF32 would score below the f32
    store's precision)."""
    return dim == MMA_DIM and dtype in (torch.bfloat16, torch.float16, torch.int8)


def dedup_run_pairs(dtype: torch.dtype, dim: int, nq: int) -> int:
    """Pairs of one doc per K3 run: ``RUN_PAIRS``, and in the tensor-core
    body no more than its ``MMA_QTILES`` query tiles of 16 rows hold."""
    if not uses_mma(dtype, dim):
        return RUN_PAIRS
    return max(1, min(RUN_PAIRS, MMA_QTILES // max(1, -(-nq // 16))))


def dedup_layout(candidates: torch.Tensor, lengths: torch.Tensor, run_pairs: int = RUN_PAIRS):
    """K3's bookkeeping (port of ``maxsim_rerank.py:306-326``), on the
    candidates' device and without a wait for it.

    The flattened pairs sort stably by doc id, -1 and out-of-range ids
    first (as -1). Each doc's pairs are then cut into runs of at most
    ``run_pairs`` (:func:`dedup_run_pairs`). Returns ``(sorted_ids, order,
    starts)``, all int32: the sorted doc ids (-1 for invalid pairs), the
    sort permutation (``order[j]`` is the flat [B*K] index of sorted pair
    ``j``, so a pair's query is ``order[j] // K``), and the first sorted
    position of each run followed by ``B*K`` up to the bound
    ``min(B*K, ceil(B*K / run_pairs) + D)`` on the run count, plus one:
    the CUDA-core body launches one block a slot, and has a block's run and
    the next run's start for each; the tensor-core body counts the runs.
    """
    dev = candidates.device
    flat = candidates.reshape(-1).long()
    total, n_docs = flat.numel(), lengths.shape[0]
    valid = (flat >= 0) & (flat < n_docs)
    sorted_ids, order = torch.sort(torch.where(valid, flat, -1), stable=True)
    pos = torch.arange(total, device=dev)
    live = sorted_ids >= 0
    first = torch.ones(total, dtype=torch.bool, device=dev)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    doc_start = torch.cummax(torch.where(first & live, pos, 0), dim=0).values
    run_first = live & ((pos - doc_start) % run_pairs == 0)
    n_blocks = max(1, min(total, -(-total // run_pairs) + n_docs))
    # one spare slot past the sentinel soaks up the positions that start no run
    starts = torch.full((n_blocks + 2,), total, dtype=torch.int32, device=dev)
    slot = torch.where(run_first, torch.cumsum(run_first, dim=0) - 1, n_blocks + 1)
    starts.scatter_(0, slot, pos.to(torch.int32))
    return sorted_ids.to(torch.int32), order.to(torch.int32), starts[:n_blocks + 1].contiguous()


def rerank_candidates_dedup(
    flat: torch.Tensor,  # [N + pad, dim] ragged store (f32/bf16/f16/int8 codes)
    offsets: torch.Tensor,  # [D] int32
    lengths: torch.Tensor,  # [D] int32
    queries: torch.Tensor,  # [B, NQ, dim] l2-normalised tokens
    qmask: torch.Tensor,  # [B, NQ] 0/1 (bool or float)
    candidates: torch.Tensor,  # [B, K] doc ids, -1 = padding
    max_len: int,
    doc_scales: Optional[torch.Tensor] = None,  # [D] f32 per-doc scales
) -> torch.Tensor:
    """K2's scores [B, K] f32 with the pairs sorted by doc (K3): each run
    of at most :func:`dedup_run_pairs` pairs of one doc reads the doc's rows
    once for all of them. On bf16, f16 and int8 stores at dim 128 the
    tensor-core body scores them (``mma_launches`` counts it): the same
    exact products, f32 sums in the tensor cores' order, so within about
    1e-6 of K2 and not bit-equal to it."""
    if on_cpu(flat):
        return rerank_candidates_dedup_ref(flat, offsets, lengths, queries, qmask,
                                           candidates, max_len, doc_scales)
    q, qm, cand = check_rerank_args(flat, offsets, lengths, queries, qmask, candidates,
                                    doc_scales)
    (b, nq, dim), k = queries.shape, candidates.shape[1]
    if not pair_kernels_fit(flat.element_size(), dim, nq):
        raise ValueError(f"query of {nq} tokens does not fit K3's shared memory")
    out = torch.full((b * k,), NEG_INF, dtype=torch.float32, device=flat.device)
    if b == 0 or k == 0:
        return out.view(b, k)
    mma = uses_mma(flat.dtype, dim) and nq > 0
    run_pairs = dedup_run_pairs(flat.dtype, dim, nq)
    sorted_ids, order, starts = dedup_layout(cand, lengths, run_pairs)
    lib = _build.load_library()
    if mma:  # the library refuses a run_pairs past what its shared arrays hold
        err = lib.vrt_rerank_candidates_dedup_mma(
            flat.device.index, ptr(flat), DTYPE_CODES[flat.dtype], ptr(offsets), ptr(lengths),
            ptr(doc_scales), ptr(q), ptr(qm), b, nq, k, ptr(sorted_ids), ptr(order),
            ptr(starts), starts.numel() - 1, run_pairs, ptr(out), stream_ptr(flat.device))
    else:
        err = lib.vrt_rerank_candidates_dedup(
            flat.device.index, ptr(flat), DTYPE_CODES[flat.dtype], ptr(offsets), ptr(lengths),
            ptr(doc_scales), offsets.shape[0], ptr(q), DTYPE_CODES[q.dtype], ptr(qm), b, nq,
            dim, k, ptr(sorted_ids), ptr(order), ptr(starts), starts.numel() - 1, ptr(out),
            stream_ptr(flat.device))
    _build.check(err, "rerank_candidates_dedup launch")
    rerank_candidates_dedup.launches += 1
    rerank_candidates_dedup.mma_launches += mma
    return out.view(b, k)


rerank_candidates_dedup.launches = 0
rerank_candidates_dedup.mma_launches = 0  # of them, the tensor-core body's


def rerank_candidates_dedup_ref(flat, offsets, lengths, queries, qmask, candidates,
                                max_len: int, doc_scales=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rerank_candidates_dedup`, through the
    kernel's own layout: each sorted pair is scored against the doc of the
    run that holds it (``sorted_ids[starts[run]]``, as the block reads it),
    with the query ``order[j] // K``, and the scores scatter back through
    ``order``. A wrong run boundary or permutation shows as a wrong score."""
    b, k = candidates.shape
    total = b * k
    run_pairs = dedup_run_pairs(flat.dtype, flat.shape[1], queries.shape[1])
    sorted_ids, order, starts = dedup_layout(candidates, lengths, run_pairs)
    pos = torch.arange(total, dtype=torch.int32, device=flat.device)
    run = torch.searchsorted(starts, pos, right=True) - 1  # -1 before the first run
    doc = torch.where(run >= 0, sorted_ids[starts[run.clamp(min=0)].long()], -1).long()
    safe = doc.clamp(min=0)
    lens = torch.where(doc >= 0, lengths.long()[safe], 0)
    scales = None if doc_scales is None else doc_scales[safe]
    scores = pair_scores(flat, offsets[safe], lens, queries, qmask, order.long() // k,
                         max_len, scales)
    out = torch.full((total,), NEG_INF, dtype=torch.float32, device=flat.device)
    out[order.long()] = scores
    return out.view(b, k)
