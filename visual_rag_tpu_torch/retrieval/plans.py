"""Query plans of the batched engine: device-side query prep, stage-1, top-k
cut, rerank and final top-k.

Port of ``visual_rag_tpu/retrieval/plans.py:33-178``. The JAX plans are
single ``jit`` dispatches; these are plain eager functions whose device
work PyTorch queues asynchronously. Capturing them as CUDA graphs is later
work (ROADMAP A4). The intermediate cut is always exact (``torch.topk``):
the JAX engine's ``lax.approx_max_k`` at >= 65536 docs has no counterpart
here (ROADMAP, declared differences).
"""

from __future__ import annotations

from typing import Dict

import torch

from visual_rag_tpu_torch.ops.kernels.refine import refine_window
from visual_rag_tpu_torch.retrieval.local import (
    NEG_INF,
    gathered_tokens_padded,
    local_rerank,
    local_stage1,
    refine_topk,
)
from visual_rag_tpu_torch.tracing import span


def _prep_wire(q1, q2, q3, wire: str, b: int, nq: int):
    """Device-side query prep for either wire format.

    padded: q1 = [B, NQ, dim] raw tokens, q2 = [B, NQ] qmask, q3 = None.
    packed: q1 = [G*Rg, dim] raw packed tokens, q2 = [G*Rg] pos, q3 = [G, Rg]
    qid (wire.pack_queries_grouped). Returns (tokens [B, NQ, dim]
    l2-normalised, qmask [B, NQ] f32, pooled [B, dim], packed dict or None).
    """
    if wire == "packed":
        return _prep_queries_packed(q1, q2, q3, b, nq)
    tokens, pooled = _prep_queries(q1, q2)
    return tokens, q2.float(), pooled, None


def _prep_queries_packed(packed, pos, qid, b: int, nq: int):
    """Packed wire -> the padded [B, NQ, dim] view (one row scatter; pad
    rows carry pos = B*NQ and land in a dropped extra row), plus the packed
    rows l2-normalised for the scan and stage-1 kernels, their in-group
    owners ``qid`` and row weights ``w`` (1 on real rows, 0 on pad rows)."""
    t = packed.float()
    dim = t.shape[1]
    p = pos.long()
    flat_t = torch.zeros((b * nq + 1, dim), dtype=torch.float32, device=t.device)
    flat_t[p] = t
    flat_m = torch.zeros((b * nq + 1,), dtype=torch.float32, device=t.device)
    flat_m.index_fill_(0, p, 1.0)  # flat_m[p] = 1.0 would copy the scalar up and wait
    qmask = flat_m[:b * nq].reshape(b, nq)
    tokens, pooled = _prep_queries(flat_t[:b * nq].reshape(b, nq, dim), qmask)
    tn = t * (qid.reshape(-1) >= 0).float()[:, None]
    tn = tn / (torch.linalg.vector_norm(tn, dim=-1, keepdim=True) + 1e-8)
    return tokens, qmask, pooled, {"q": tn, "qid": qid.to(torch.int32),
                                   "w": (qid.reshape(-1) >= 0).float()}


def _prep_queries(raw, qmask):
    """Raw padded tokens -> (l2-normalised f32 tokens, l2-normalised mean
    of the raw tokens as the pooled query)."""
    qm = qmask.float()
    t = raw.float() * qm[..., None]
    tokens = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-8)
    mean = t.sum(dim=1) / qm.sum(dim=1, keepdim=True).clamp(min=1.0)
    pooled = mean / (torch.linalg.vector_norm(mean, dim=-1, keepdim=True) + 1e-8)
    return tokens, pooled


def _topk_masked(scores: torch.Tensor, k: int, doc_mask=None):
    """Exact top-k per row; ids of ``NEG_INF`` entries become -1. Docs
    outside ``doc_mask`` (a [D] bool filter mask; None = unfiltered) score
    ``NEG_INF`` first, so the cut stays exact over the docs it admits."""
    if doc_mask is not None:
        scores = torch.where(doc_mask[None, :], scores, NEG_INF)
    vals, idx = torch.topk(scores, k, dim=-1)
    return vals, torch.where(vals > NEG_INF / 2, idx, -1).to(torch.int32)


def single_plan(s1: Dict, ragged: Dict, doc_mask, q1, q2, q3=None, *, kind: str, k: int,
                wire: str = "padded", b: int = 0, nq: int = 0):
    """``single_*``: one store scored for every doc (stage-1 ``kind``), top-k.
    ``single_full`` on an ``int8_refined`` store cuts the int8 scan to the
    refine window and re-scores it (JAX ``plans.py:114-118``)."""
    tokens, qmask, pooled, packed = _prep_wire(q1, q2, q3, wire, b, nq)
    with span("search.stage1", device=tokens.device):
        scores = local_stage1(kind, s1, ragged, tokens, qmask, pooled, packed, b)
    if kind == "tokens_ragged" and ragged.get("res4") is not None:
        vals8, cand = _topk_masked(scores, refine_window(k, scores.shape[1]), doc_mask)
        return refine_topk(ragged, tokens, qmask, cand, vals8, k)
    return _topk_masked(scores, k, doc_mask)


def two_stage_plan(s1: Dict, ragged: Dict, doc_mask, q1, q2, q3=None, *, kind: str,
                   pk: int, k: int, impl: str = "plain", wire: str = "padded", b: int = 0,
                   nq: int = 0):
    """``two_stage``: stage-1 scores, exact top-``pk`` cut, exact MaxSim
    rerank of the candidates (refined on ``int8_refined``), final top-``k``."""
    tokens, qmask, pooled, packed = _prep_wire(q1, q2, q3, wire, b, nq)
    with span("search.stage1", device=tokens.device):
        scores = local_stage1(kind, s1, ragged, tokens, qmask, pooled, packed, b,
                              s1_prefetch=True)
    _, cand = _topk_masked(scores, pk, doc_mask)
    rr = local_rerank(ragged, tokens, qmask, cand, impl, packed, b)
    return refine_topk(ragged, tokens, qmask, cand, rr, k)


def three_stage_plan(gstore: Dict, estore: Dict, ragged: Dict, doc_mask, q1, q2, q3=None,
                     *, s1k: int, s2k: int, k: int, impl: str = "plain",
                     wire: str = "padded", b: int = 0, nq: int = 0):
    """``three_stage``: pooled query vs the global vectors, top-``s1k``; the
    query tokens vs the experimental pooled rows of those candidates only,
    top-``s2k``; exact MaxSim rerank, final top-``k``. Returns (scores,
    ids, stage-1 scores, stage-2 scores), the last two at the winners. On
    an ``int8_refined`` store the winners come from the refine window, not
    in stage-2 order, so each winner's stage-2 score is found by matching
    its id in the stage-2 candidates (JAX ``plans.py:163-175``)."""
    tokens, qmask, pooled, packed = _prep_wire(q1, q2, q3, wire, b, nq)
    with span("search.stage1", device=tokens.device):
        s1 = local_stage1("pooled_single", gstore, ragged, tokens, qmask, pooled, packed, b)
    _, c1 = _topk_masked(s1, s1k, doc_mask)
    s2c = gathered_tokens_padded(estore, tokens, qmask, c1)  # [B, s1k]
    s2k = min(s2k, s1k)
    k = min(k, s2k)  # the stage-2 pool bounds the final cut
    v2, pos2 = torch.topk(s2c, s2k, dim=1)
    c2 = torch.where(v2 > NEG_INF / 2, c1.gather(1, pos2), -1).to(torch.int32)
    rr = local_rerank(ragged, tokens, qmask, c2, impl, packed, b)
    if ragged.get("res4") is None:
        vals, pos = torch.topk(rr, k, dim=1)
        idx = torch.where(vals > NEG_INF / 2, c2.gather(1, pos), -1).to(torch.int32)
        s2_at = v2.gather(1, pos)
    else:
        vals, idx = refine_topk(ragged, tokens, qmask, c2, rr, k)
        match = (c2[:, None, :] == idx[:, :, None]) & (idx[:, :, None] >= 0)
        pos2 = match.to(torch.int32).argmax(dim=2)  # ids are unique in a row of c2
        s2_at = torch.where(idx >= 0, v2.gather(1, pos2), NEG_INF)
    fi = idx.clamp(min=0).long()
    return vals, idx, s1.gather(1, fi), s2_at
