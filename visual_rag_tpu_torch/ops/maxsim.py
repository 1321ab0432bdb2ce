"""MaxSim late-interaction scoring in plain PyTorch.

Port of ``visual_rag_tpu/ops/maxsim.py``: score(Q, D) = sum_q max_d <q, d>.
Every function is one einsum (or matmul) with f32 accumulation, which XLA
computes outside any Pallas kernel in the JAX package, so it stays plain
torch here (cuBLAS on the card). The training loss needs
:func:`maxsim_matrix_padded`; the rest keeps the module's API.

Masking is the JAX module's (``:97-135``): a masked doc token scores
``NEG_INF`` before the row max, a doc with no valid token scores 0, and
masked query tokens add 0. Inputs may be torch tensors or numpy arrays;
results are f32 tensors on the input's device (Python floats for the
single-query helpers, as in JAX).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from visual_rag_tpu_torch.ops.kernels._checks import NEG_INF

__all__ = [
    "l2_normalize",
    "compute_maxsim_score",
    "compute_maxsim_batch",
    "maxsim_scores_padded",
    "maxsim_matrix_padded",
    "pad_ragged",
]

_EPS = 1e-8  # the reference's additive normalization epsilon


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def l2_normalize(x, dim: int = -1, eps: float = _EPS) -> torch.Tensor:
    """x / (||x|| + eps) along ``dim``, in f32."""
    x = _f32(x)
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def compute_maxsim_score(query_embedding, doc_embedding, normalize: bool = True) -> float:
    """MaxSim of one query [nq, dim] against one document [nd, dim]."""
    q, d = _f32(query_embedding), _f32(doc_embedding)
    if normalize:
        q, d = l2_normalize(q), l2_normalize(d)
    return float((q @ d.T).amax(dim=1).sum())


def compute_maxsim_batch(query_embedding, doc_embeddings: Sequence,
                         normalize: bool = True) -> list:
    """MaxSim of one query against a list of ragged documents."""
    q = _f32(query_embedding)
    if normalize:
        q = l2_normalize(q)
    out = []
    for doc in doc_embeddings:
        d = _f32(doc)
        if normalize:
            d = l2_normalize(d)
        out.append(float((q @ d.T).amax(dim=1).sum()))
    return out


def _masked_max_sum(sims: torch.Tensor, doc_mask: torch.Tensor, query_mask) -> torch.Tensor:
    """sims [..., n_docs, nq, t] -> [..., n_docs] with the JAX module's masking.
    ``doc_mask`` [n_docs, t]; ``query_mask`` broadcast against [..., n_docs, nq]."""
    sims = sims.masked_fill(~doc_mask[:, None, :], NEG_INF)
    per_q = sims.amax(dim=-1)
    per_q = torch.where(doc_mask.any(dim=1)[:, None], per_q, 0.0)
    if query_mask is not None:
        per_q = per_q * query_mask
    return per_q.sum(dim=-1)


def maxsim_scores_padded(query, docs, doc_mask, query_mask: Optional[torch.Tensor] = None):
    """One query [nq, dim] against padded docs [n_docs, t, dim] with
    ``doc_mask`` [n_docs, t] -> [n_docs] f32 scores."""
    q, d = _f32(query), _f32(docs)
    doc_mask = torch.as_tensor(doc_mask, dtype=torch.bool, device=d.device)
    sims = torch.einsum("qd,ntd->nqt", q, d)
    qm = None if query_mask is None else _f32(query_mask).to(d.device)[None, :]
    return _masked_max_sum(sims, doc_mask, qm)


def maxsim_matrix_padded(queries, query_mask, docs, doc_mask) -> torch.Tensor:
    """All pairs: queries [B, nq, dim] (mask [B, nq]) against docs [N, t, dim]
    (mask [N, t]) -> [B, N] f32 scores (the training loss's score matrix).
    Its [B, N, nq, t] f32 transient is ~9 MB at ColSmol's training shapes."""
    q, d = _f32(queries), _f32(docs)
    doc_mask = torch.as_tensor(doc_mask, dtype=torch.bool, device=d.device)
    sims = torch.einsum("bqd,ntd->bnqt", q, d)
    return _masked_max_sum(sims, doc_mask, _f32(query_mask).to(d.device)[:, None, :])


def pad_ragged(mats: Sequence, max_len: Optional[int] = None, dim: Optional[int] = None):
    """Host helper: ragged [n_i, dim] matrices -> ([N, T, dim] f32, [N, T] bool)."""
    mats = [np.asarray(m, dtype=np.float32) for m in mats]
    if dim is None:
        dim = mats[0].shape[1] if mats else 128
    if max_len is None:
        max_len = max((m.shape[0] for m in mats), default=1)
    out = np.zeros((len(mats), max_len, dim), dtype=np.float32)
    mask = np.zeros((len(mats), max_len), dtype=bool)
    for i, m in enumerate(mats):
        t = min(m.shape[0], max_len)
        out[i, :t] = m[:t]
        mask[i, :t] = True
    return torch.from_numpy(out), torch.from_numpy(mask)
