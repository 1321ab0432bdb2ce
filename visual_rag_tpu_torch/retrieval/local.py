"""Scoring bodies of the query plans: stage-1, rerank and the final top-k.

Port of the shard-local bodies in ``visual_rag_tpu/parallel/sharded.py``
(the single-device engine is their one-shard case):

- :func:`local_pooled_padded` <- ``_local_pooled_padded`` (``:341-351``), a
  plain product over the P-leading pooled store. XLA computed it outside
  any kernel, so here it is a ``torch.matmul``, one per pooled row with a
  running max, which bounds the transient to one [B, D] tile.
- :func:`local_rerank` <- ``_local_rerank`` (``:425-530``), branches
  ``plain`` and ``scan``. The ``lax.map`` chunking at B*K > 64k
  (``:508-524``) worked around the TPU's scalar memory; one CUDA launch
  takes any B*K, so it is gone.
- :func:`local_tokens_ragged` <- ``_local_tokens_ragged`` (``:580-634``),
  on the packed and the padded wire, without length buckets.
- :func:`local_stage1` <- ``_local_stage1`` (``:637-662``), kinds
  ``pooled_padded`` and ``tokens_ragged``.
- :func:`refine_topk` <- ``_refine_topk`` (``:730-742``), plain stores.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from visual_rag_tpu_torch.ops.kernels.maxsim_rerank import rerank_candidates
from visual_rag_tpu_torch.ops.kernels.maxsim_scan import exhaustive_scores_packed

NEG_INF = -1e30


def local_pooled_padded(s1: Dict, pooled: torch.Tensor) -> torch.Tensor:
    """[B, D] max over each doc's valid pooled rows of the pooled query's dot.

    The query is cast to the store dtype (the TPU engine's bf16 compute),
    then the product is f32. Docs without rows score 0.
    """
    vals_t, mask_t = s1["vals_t"], s1["mask_t"]  # [P, D, dim], [P, D] bool
    q = pooled.to(vals_t.dtype).float()
    out = None
    for p in range(vals_t.shape[0]):
        s = (q @ vals_t[p].float().T).masked_fill(~mask_t[p][None, :], NEG_INF)
        out = s if out is None else torch.maximum(out, s)
    return torch.where(mask_t.any(dim=0)[None, :], out, 0.0)


def local_tokens_ragged(ragged: Dict, tokens: torch.Tensor, qmask: torch.Tensor,
                        packed: Optional[Dict], b: int) -> torch.Tensor:
    """[B, D] exact MaxSim of every query against every doc (the scan).

    The padded wire goes through the same kernel as a packing with one
    query per group: group i is query i's NQ rows, owned where qmask is set.
    """
    if packed is not None:
        q, qid = packed["q"], packed["qid"]
    else:
        q = tokens.reshape(-1, tokens.shape[2])
        qid = torch.where(qmask > 0, 0, -1).to(torch.int32)  # [B, NQ]
    return exhaustive_scores_packed(ragged["flat"], ragged["offsets"], ragged["lengths"],
                                    q, qid, ragged["max_len"], b)


def local_rerank(ragged: Dict, tokens: torch.Tensor, qmask: torch.Tensor,
                 cand: torch.Tensor, impl: str, packed: Optional[Dict], b: int):
    """[B, K] exact MaxSim of each query's candidates.

    ``plain``: the rerank kernel reads each candidate's rows. ``scan``: one
    exhaustive pass over the whole store, then a gather at the candidates;
    it needs the packed wire (the engine's policy picks it when B*K
    candidate windows outnumber the docs severalfold).
    """
    if impl == "scan":
        scores = local_tokens_ragged(ragged, tokens, qmask, packed, b)
        out = scores.gather(1, cand.clamp(min=0).long())
        return torch.where(cand >= 0, out, NEG_INF)
    if impl != "plain":
        raise ValueError(f"unknown rerank impl {impl!r}")
    return rerank_candidates(ragged["flat"], ragged["offsets"], ragged["lengths"],
                             tokens, qmask, cand, ragged["max_len"])


def local_stage1(kind: str, s1: Dict, ragged: Dict, tokens, qmask, pooled,
                 packed: Optional[Dict], b: int) -> torch.Tensor:
    if kind == "pooled_padded":
        return local_pooled_padded(s1, pooled)
    if kind == "tokens_ragged":
        return local_tokens_ragged(ragged, tokens, qmask, packed, b)
    raise ValueError(kind)


def refine_topk(cand: torch.Tensor, rr: torch.Tensor, k: int):
    """Final top-k of the rerank scores: (scores [B, k], doc ids, -1 where
    the score is a padding ``NEG_INF``)."""
    vals, pos = torch.topk(rr, k, dim=1)
    idx = torch.where(vals > NEG_INF / 2, cand.gather(1, pos), -1)
    return vals, idx.to(torch.int32)
