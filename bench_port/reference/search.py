"""Plain reference of ``two_stage`` search, and the comparison that decides
``correct`` for the search cells.

Plain PyTorch over the harness's own corpus tensors; it imports nothing of
the program. The semantics are the engine's (``retrieval/plans.py``):

- query tokens l2-normalised, ``t / (||t|| + 1e-8)``; the pooled query the
  normalised mean of the raw tokens;
- both rounded to the store's dtype before their products (the engine
  scores a bf16 store with bf16-rounded queries), products and sums in f32;
- stage-1: per doc, the largest dot of the pooled query with its valid
  pooled rows (a doc with none scores 0); the top ``prefetch_k`` exactly;
- rerank: exact MaxSim, the sum over valid query tokens of the largest dot
  with the doc's token rows; the final top ``top_k``.

``precision="bf16"`` is the control: the same, with every product rounded
to bf16 (a bf16 matmul's output), the step below f32 that would tempt a
later change. TF32 would change nothing here: bf16 inputs are exact in it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bench_port.reference.colvlm import exact_f32

NEG = -1e30


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b.T of store-dtype-rounded operands, in f32 or (control) bf16."""
    if precision == "bf16":
        return (a.to(torch.bfloat16) @ b.to(torch.bfloat16).T).float()
    return a.float() @ b.float().T


def prep(raw: Sequence[np.ndarray], device, sdt) -> Tuple[torch.Tensor, torch.Tensor,
                                                            torch.Tensor]:
    """(tokens [B, NQ, dim], mask [B, NQ], pooled [B, dim]), rounded to the
    store dtype and back to f32."""
    b, nq, dim = len(raw), max(q.shape[0] for q in raw), raw[0].shape[1]
    t = torch.zeros((b, nq, dim), dtype=torch.float32)
    m = torch.zeros((b, nq), dtype=torch.bool)
    for i, q in enumerate(raw):
        t[i, :q.shape[0]] = torch.from_numpy(np.ascontiguousarray(q))
        m[i, :q.shape[0]] = True
    t, m = t.to(device), m.to(device)
    mean = t.sum(1) / m.sum(1, keepdim=True).float()
    pooled = mean / (torch.linalg.vector_norm(mean, dim=-1, keepdim=True) + 1e-8)
    tokens = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-8)
    return tokens.to(sdt).float(), m, pooled.to(sdt).float()


def stage1(pooled_q: torch.Tensor, pooled: torch.Tensor, pmask: torch.Tensor,
           precision: str, block: int = 1 << 15) -> torch.Tensor:
    """[B, D] the largest dot with each doc's valid pooled rows (0 without)."""
    d, p, dim = pooled.shape
    out = torch.empty((pooled_q.shape[0], d), dtype=torch.float32, device=pooled.device)
    for s in range(0, d, block):
        e = min(d, s + block)
        sims = _mm(pooled_q, pooled[s:e].reshape(-1, dim), precision).view(-1, e - s, p)
        sims = sims.masked_fill(~pmask[s:e][None], NEG).amax(-1)
        out[:, s:e] = torch.where(pmask[s:e].any(-1)[None], sims, 0.0)
    return out


def maxsim(tokens: torch.Tensor, qmask: torch.Tensor, flat: torch.Tensor,
           offsets: torch.Tensor, lengths: torch.Tensor, docs: torch.Tensor,
           precision: str) -> torch.Tensor:
    """[K] exact MaxSim of one query (tokens [NQ, dim], qmask [NQ]) with
    docs [K] (-1 scores NEG)."""
    safe = docs.clamp(min=0).long()
    max_len = int(lengths[safe].max())
    rows = offsets[safe].long()[:, None] + torch.arange(max_len, device=flat.device)[None]
    ok = torch.arange(max_len, device=flat.device)[None] < lengths[safe][:, None]
    d = flat[rows.clamp(max=flat.shape[0] - 1)]  # [K, L, dim]
    sims = _mm(tokens[qmask], d.reshape(-1, d.shape[-1]), precision)
    sims = sims.view(-1, d.shape[0], max_len).masked_fill(~ok[None], NEG).amax(-1)
    score = sims.sum(0)
    return torch.where((docs >= 0) & (lengths[safe] > 0), score, NEG)


def two_stage(corpus, raw: Sequence[np.ndarray], prefetch_k: int, top_k: int,
              precision: str = "f32", chunk: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """(ids [B, top_k] int64, scores [B, top_k] f32) of the reference."""
    sdt = corpus.flat.dtype
    ids, scores = [], []
    with exact_f32(), torch.no_grad():
        for s in range(0, len(raw), chunk):
            tok, m, pq = prep(raw[s:s + chunk], corpus.flat.device, sdt)
            s1 = stage1(pq, corpus.pooled, corpus.pooled_mask, precision)
            cand = torch.topk(s1, min(prefetch_k, s1.shape[1]), dim=1).indices
            for i in range(cand.shape[0]):
                rr = maxsim(tok[i], m[i], corpus.flat, corpus.offsets, corpus.lengths,
                            cand[i], precision)
                v, pos = torch.topk(rr, min(top_k, rr.shape[0]))
                ids.append(cand[i][pos].cpu().numpy())
                scores.append(v.cpu().numpy())
    return np.stack(ids), np.stack(scores)


def exact_scores(corpus, raw: Sequence[np.ndarray], docs: np.ndarray) -> np.ndarray:
    """[B, K] f32 exact MaxSim of each query with the given doc ids (-1: NEG)."""
    out = []
    with exact_f32(), torch.no_grad():
        for i, q in enumerate(raw):
            tok, m, _ = prep([q], corpus.flat.device, corpus.flat.dtype)
            d = torch.from_numpy(docs[i]).to(corpus.flat.device)
            out.append(maxsim(tok[0], m[0], corpus.flat, corpus.offsets, corpus.lengths, d,
                              "f32").cpu().numpy())
    return np.stack(out)


def compare(corpus, raw: Sequence[np.ndarray], got_ids: np.ndarray, got_scores: np.ndarray,
            ref_ids: np.ndarray, ref_scores: np.ndarray) -> Dict[str, float]:
    """The numbers compared for ``correct`` over the sampled answers:

    - ``score_gap``: the largest |score returned - the reference's exact
      MaxSim of the doc returned| (a score altered, or a wrong doc's score);
    - ``rank_gap``: the largest amount by which the reference's r-th best
      score exceeds the r-th best exact score of the docs returned (a doc
      returned that is not among the best, or one missing). A duplicate id
      or a missing hit reads as the full score of the reference's.
    """
    exact = exact_scores(corpus, raw, got_ids)
    score_gap = float(np.max(np.abs(np.where(got_ids >= 0, got_scores - exact, 0.0)),
                             initial=0.0))
    missing = (got_ids < 0).any(axis=1)
    dup = np.array([len(set(r.tolist())) < len(r) for r in got_ids])
    true_sorted = -np.sort(-np.where(got_ids >= 0, exact, -np.inf), axis=1)
    gap = ref_scores - true_sorted
    gap[missing | dup] = np.abs(ref_scores[missing | dup])
    return {"score_gap": score_gap, "rank_gap": float(np.max(gap, initial=0.0))}


def sample_indices(n: int, k: int, seed: int) -> List[int]:
    """k of n answered requests, drawn from the seed."""
    rng = np.random.default_rng([seed, 7])
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def control_readings(corpus, raw: Sequence[np.ndarray], prefetch_k: int,
                     top_k: int) -> Dict[str, float]:
    """The control: the reference computed in bf16 put in the program's
    place, read by :func:`compare` against the f32 reference."""
    got_ids, got_scores = two_stage(corpus, raw, prefetch_k, top_k, precision="bf16")
    ref_ids, ref_scores = two_stage(corpus, raw, prefetch_k, top_k)
    return compare(corpus, raw, got_ids, got_scores, ref_ids, ref_scores)
