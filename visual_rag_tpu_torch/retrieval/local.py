"""Scoring bodies of the query plans: stage-1, rerank and the final top-k.

Port of the shard-local bodies in ``visual_rag_tpu/parallel/sharded.py``
(the single-device engine is their one-shard case):

- :func:`local_pooled_padded` <- ``_local_pooled_padded`` (``:341-351``), the
  pooled query against the P-leading pooled store. XLA fused its einsum,
  where and max on the TPU; here that fusion is a kernel on the tensor
  cores (``pooled_stage1_scores``, ``ops/kernels/prefetch_topk.py``) for
  bf16, f16 and int8 stores. An f32 store keeps the plain loop of f32
  ``torch.matmul``s, one per pooled row with a running max: the tensor
  cores would need TF32 for it.
- :func:`rerank_route` <- the JAX engine's ``EngineCommon._rerank_impl``
  (``retrieval/engine.py:149-193``): which rerank a batch asks for. Then
  :func:`local_rerank` <- ``_local_rerank`` (``:425-530``), every branch:
  ``plain`` (K2), ``dedup`` (K3), ``sweep`` (K4) and ``scan`` (K1), each
  falling back where its kernel does not take the real query. The
  ``lax.map`` query chunking of all three reranks and the 56k-entry and
  4 MB guards of ``dedup`` (``:458-524``) worked around the TPU's scalar
  and vector memories; one CUDA launch takes any B*K, so they are gone.
- :func:`local_tokens_padded` <- ``_local_tokens_padded`` (``:308-338``) and
  :func:`local_tokens_padded_packed` <- ``_local_tokens_padded_packed``
  (``:533-573``): the tokens-vs-pooled stage-1 through the K5/K6/K7 kernel
  (``ops/kernels/prefetch_topk.py``). A padded batch of one goes through
  the K7 entry point, the per-query kernel.
- :func:`local_pooled_single` <- ``_local_pooled_single`` (``:354-362``), a
  plain ``torch.matmul``: XLA computed it outside any kernel.
- :func:`gathered_tokens_padded` <- ``_gathered_tokens_padded``
  (``:365-419``), plain torch for the same reason, query-chunked under
  ``GATHER_BUDGET_BYTES``.
- :func:`local_tokens_ragged` <- ``_local_tokens_ragged`` (``:580-634``),
  on the packed and the padded wire, without length buckets.
- :func:`local_stage1` <- ``_local_stage1`` (``:637-662``), kinds
  ``tokens_padded``, ``pooled_padded``, ``pooled_single`` and
  ``tokens_ragged``, with the qdot branch of a prefetch tokens stage-1.
- :func:`refine_topk` <- ``_refine_topk`` (``:730-751``), with the int4
  residual refine of ``int8_refined`` stores (``ops/kernels/refine.py``).

int8 stores (``:304-305``): queries are rounded to bf16 against int8 codes
everywhere outside the qdot bodies, and every scorer applies the store's
scales where the JAX bodies do. The qdot bodies (int8 query codes, integer
dots) run where the JAX package runs them: the scan of an ``int8_refined``
ragged store (``:593-599``) and a prefetch tokens stage-1 over an int8
pooled store (``:640-649``), the latter unless ``VISUALRAG_TOKENS_QDOT=0``
was set when this module was imported (the JAX package's own opt-out,
``:76-78``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from visual_rag_tpu_torch.ops.kernels._checks import NEG_INF, ceil32, compute_dtype
from visual_rag_tpu_torch.ops.kernels.maxsim_rerank import (
    pair_kernels_fit,
    rerank_candidates,
    rerank_candidates_dedup,
)
from visual_rag_tpu_torch.ops.kernels.maxsim_scan import exhaustive_scores_packed
from visual_rag_tpu_torch.ops.kernels.maxsim_sweep import (
    SWEEP_R_STEP,
    rerank_candidates_sweep,
    sweep_supported,
)
from visual_rag_tpu_torch.ops.kernels.prefetch_topk import (
    pooled_maxsim_scores,
    pooled_maxsim_scores_packed,
    pooled_maxsim_scores_qbatch,
    pooled_stage1_scores,
    pooled_stage1_scores_ref,
)
from visual_rag_tpu_torch.ops.kernels.refine import refine_rerank, refine_window

# device-memory cap of the stage-2 candidate gather (sharded.py:417-419)
GATHER_BUDGET_BYTES = 320 * 1024 * 1024
# the qdot prefetch stage-1 opt-out, read once at import (sharded.py:76-78)
TOKENS_QDOT = os.environ.get("VISUALRAG_TOKENS_QDOT", "1") != "0"
# the JAX engine's rerank thresholds (engine.py:126-132)
DEDUP_MIN_BATCH = 64
SWEEP_MIN_COV = 6.0
SCAN_MIN_CAND_RATIO = 4.0  # scan when B*K >= this * D


def local_tokens_padded(s1: Dict, tokens: torch.Tensor, qmask: torch.Tensor,
                        qdot: bool = False) -> torch.Tensor:
    """[B, D] tokens-vs-pooled stage-1 on the padded wire (K6; K7 at B = 1)."""
    fn = pooled_maxsim_scores if tokens.shape[0] == 1 else pooled_maxsim_scores_qbatch
    return fn(s1["vals_t"], s1["mask_t"], tokens, qmask, s1.get("scales_t"), qdot_int8=qdot)


def local_tokens_padded_packed(s1: Dict, packed: Dict, b: int,
                               qdot: bool = False) -> torch.Tensor:
    """[B, D] tokens-vs-pooled stage-1 on the group-packed wire (K5)."""
    return pooled_maxsim_scores_packed(s1["vals_t"], s1["mask_t"], packed["q"], packed["qid"],
                                       b, packed["w"], s1.get("scales_t"), qdot_int8=qdot)


def local_pooled_padded(s1: Dict, pooled: torch.Tensor) -> torch.Tensor:
    """[B, D] max over each doc's valid pooled rows of the pooled query's dot.

    The query is rounded to the store's compute dtype (the TPU engine's
    bf16 compute; bf16 for int8 codes), then the product is f32, times the
    row's scale on an int8 store, before the max. Docs without rows score 0.
    The store's dtype picks the path: the f32 matmul loop for f32, the
    kernel for the others.
    """
    vals_t = s1["vals_t"]  # [P, D, dim]; mask_t [P, D] bool; scales_t [P, D] f32 for int8
    fn = pooled_stage1_scores_ref if vals_t.dtype == torch.float32 else pooled_stage1_scores
    return fn(vals_t, s1["mask_t"], pooled, s1.get("scales_t"))


def local_pooled_single(s1: Dict, pooled: torch.Tensor) -> torch.Tensor:
    """[B, D] dot of the pooled query with each doc's single vector (an
    int8 single-vector store arrives dequantized, as in the JAX engine)."""
    vals = s1["vals"]  # [D, dim]
    out = pooled.to(compute_dtype(vals.dtype)).float() @ vals.float().T
    scales = s1.get("scales")
    return out if scales is None else out * scales.float()[None, :]


def gathered_tokens_padded(estore: Dict, tokens: torch.Tensor, qmask: torch.Tensor,
                           cand: torch.Tensor) -> torch.Tensor:
    """[B, K] tokens-vs-pooled scores of each query's candidates only.

    Gathers the candidates' pooled rows ([P, Bc, K, dim]) for a chunk of Bc
    queries at a time: the chunk halves until its gather and similarity
    transients fit ``GATHER_BUDGET_BYTES``. Scores are per (query, doc), so
    the chunking changes nothing. -1 candidates score ``NEG_INF``; docs
    with no valid pooled row 0.
    """
    vals_t = estore["vals_t"]
    b, k = cand.shape
    p, _, dim = vals_t.shape
    per_q = p * k * (dim * max(2, vals_t.element_size()) + tokens.shape[1] * 4)
    bc = b
    while bc > 1 and bc * per_q > GATHER_BUDGET_BYTES:
        bc //= 2
    return torch.cat([_gathered_chunk(estore, tokens[s:s + bc], qmask[s:s + bc],
                                      cand[s:s + bc]) for s in range(0, b, bc)])


def _gathered_chunk(estore: Dict, tokens, qmask, cand) -> torch.Tensor:
    vals_t, mask_t = estore["vals_t"], estore["mask_t"]
    scales_t = estore.get("scales_t")
    safe = cand.clamp(min=0).long()  # [Bc, K]
    sub = vals_t[:, safe].float()  # [P, Bc, K, dim]
    msk = mask_t[:, safe].bool()  # [P, Bc, K]
    sims = torch.einsum("bqd,pbkd->bqpk", tokens.to(compute_dtype(vals_t.dtype)).float(), sub)
    if scales_t is not None:
        sims = sims * scales_t[:, safe].float().permute(1, 0, 2)[:, None]
    sims = sims.masked_fill(~msk.permute(1, 0, 2)[:, None], NEG_INF)
    per_q = sims.amax(dim=2)  # [Bc, NQ, K]
    per_q = torch.where(msk.any(dim=0)[:, None, :], per_q, 0.0)
    scores = (per_q * qmask.float()[:, :, None]).sum(dim=1)
    return torch.where(cand >= 0, scores, NEG_INF)


def local_tokens_ragged(ragged: Dict, tokens: torch.Tensor, qmask: torch.Tensor,
                        packed: Optional[Dict], b: int) -> torch.Tensor:
    """[B, D] exact MaxSim of every query against every doc (the scan).

    The padded wire goes through the same kernel as a packing with one
    query per group: group i is query i's NQ rows, owned where qmask is set.
    An ``int8_refined`` store scans with int8 queries (qdot): its refine
    pass re-scores the final window, so the query rounding never reaches a
    returned score (``sharded.py:593-599``).
    """
    if packed is not None:
        q, qid = packed["q"], packed["qid"]
    else:
        q = tokens.reshape(-1, tokens.shape[2])
        qid = torch.where(qmask > 0, 0, -1).to(torch.int32)  # [B, NQ]
    return exhaustive_scores_packed(ragged["flat"], ragged["offsets"], ragged["lengths"],
                                    q, qid, ragged["max_len"], b, ragged.get("scales"),
                                    qdot_int8=ragged.get("res4") is not None)


def rerank_route(ragged: Dict, n_docs: int, b: int, k: int, packed: bool,
                 requested: str = "auto") -> str:
    """The rerank a batch of ``b`` (bucketed) queries asks for, ``k``
    candidates each, as the JAX engine's ``_rerank_impl`` on its K
    (``prefetch_k``, or ``stage2_k`` before the stage-1 cut) and a 32-token
    query. Where JAX asks its TPU kernels' budgets, the port asks its CUDA
    kernels' envelope (ROADMAP, declared differences); :func:`local_rerank`
    then holds the route to the real query. ``scan`` needs the packed wire
    (the JAX engine falls back with a warning).
    """
    if requested == "scan" and not packed:
        raise ValueError(
            "rerank_impl='scan' needs the packed query wire (query_wire='packed', or "
            "'auto' on CUDA from the packed wire's smallest batch); this batch goes on the "
            "padded wire")
    if requested != "auto":
        return requested
    if b < DEDUP_MIN_BATCH:
        return "plain"
    if packed and b * k >= SCAN_MIN_CAND_RATIO * n_docs:
        return "scan"
    flat, max_len = ragged["flat"], int(ragged["max_len"])
    rows, dim = flat.shape
    cov = b * k * ceil32(max_len) / max(1, rows)
    if cov >= SWEEP_MIN_COV and sweep_supported(rows, max_len, b, k, 32, dim,
                                                flat.element_size()):
        return "sweep"
    return "dedup"


def local_rerank(ragged: Dict, tokens: torch.Tensor, qmask: torch.Tensor,
                 cand: torch.Tensor, impl: str, packed: Optional[Dict], b: int):
    """[B, K] exact MaxSim of each query's candidates; every impl gives K2's
    scores, K3's tensor-core body within about 1e-6 (``sharded.py:425-530``).

    ``plain``: K2 reads each candidate's rows. ``dedup``: K3, pairs sorted
    by doc, each doc read once a run; a batch of one goes to K2 (``:477``).
    ``sweep``: K4, pairs sorted by row range; outside its envelope it runs
    ``dedup`` (``:476``). ``scan``: one exhaustive pass over the whole
    store, then a gather at the candidates; it needs the packed wire.
    """
    if impl == "scan":
        scores = local_tokens_ragged(ragged, tokens, qmask, packed, b)
        out = scores.gather(1, cand.clamp(min=0).long())
        return torch.where(cand >= 0, out, NEG_INF)
    if impl not in ("plain", "dedup", "sweep"):
        raise ValueError(f"unknown rerank impl {impl!r}")
    flat = ragged["flat"]
    args = (flat, ragged["offsets"], ragged["lengths"], tokens, qmask, cand,
            ragged["max_len"], ragged.get("scales"))
    (nb, k), (nq, dim), itemsize = cand.shape, tokens.shape[1:], flat.element_size()
    if impl == "sweep":
        if sweep_supported(flat.shape[0], ragged["max_len"], nb, k, nq, dim, itemsize):
            return rerank_candidates_sweep(*args, r_step=SWEEP_R_STEP)
        impl = "dedup"  # outside the sweep kernel's envelope
    if impl == "dedup" and nb > 1 and pair_kernels_fit(itemsize, dim, nq):
        return rerank_candidates_dedup(*args)
    return rerank_candidates(*args)


def local_stage1(kind: str, s1: Dict, ragged: Dict, tokens, qmask, pooled,
                 packed: Optional[Dict], b: int, s1_prefetch: bool = False) -> torch.Tensor:
    """[B, D] stage-1 scores of one kind. ``s1_prefetch``: the scores only
    pick candidates for an exact rerank (``two_stage``), so a tokens
    stage-1 over int8 codes may use int8 queries (``sharded.py:640-649``);
    where they are final (``single_tiles``) it keeps bf16 queries."""
    if kind == "tokens_padded":
        qdot = TOKENS_QDOT and s1_prefetch and s1["vals_t"].dtype == torch.int8
        if packed is not None:
            return local_tokens_padded_packed(s1, packed, b, qdot)
        return local_tokens_padded(s1, tokens, qmask, qdot)
    if kind == "pooled_padded":
        return local_pooled_padded(s1, pooled)
    if kind == "pooled_single":
        return local_pooled_single(s1, pooled)
    if kind == "tokens_ragged":
        return local_tokens_ragged(ragged, tokens, qmask, packed, b)
    raise ValueError(kind)


def refine_topk(ragged: Dict, tokens: torch.Tensor, qmask: torch.Tensor,
                cand: torch.Tensor, rr: torch.Tensor, k: int):
    """Final top-k of the rerank scores: (scores [B, k'], doc ids, -1 where
    the score is a padding ``NEG_INF``). Plain stores: the top-k of ``rr``.
    ``int8_refined`` stores: the int8 top ``max(32, 2k)`` window is
    re-scored at int8 + int4 precision with f32 queries, then cut to
    ``k' = min(k, window)``."""
    if ragged.get("res4") is None:
        vals, pos = torch.topk(rr, k, dim=1)
        idx = torch.where(vals > NEG_INF / 2, cand.gather(1, pos), -1)
        return vals, idx.to(torch.int32)
    rk = refine_window(k, cand.shape[1])
    v8, pos8 = torch.topk(rr, rk, dim=1)
    c8 = torch.where(v8 > NEG_INF / 2, cand.gather(1, pos8), -1).to(torch.int32)
    fine = refine_rerank(ragged["flat"], ragged["res4"], ragged["res_scales"],
                         ragged["offsets"], ragged["lengths"], tokens, qmask, c8,
                         ragged["max_len"], ragged.get("scales"))
    vals, pos = torch.topk(fine, min(k, rk), dim=1)
    idx = torch.where(vals > NEG_INF / 2, c8.gather(1, pos), -1)
    return vals, idx.to(torch.int32)
