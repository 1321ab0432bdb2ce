"""The int8_refined refine pass: exact MaxSim at int8 + int4 precision.

Port of ``visual_rag_tpu/retrieval/batch.py:511-566`` (``xla_refine_rerank``)
with the window rule and query chunking of ``visual_rag_tpu/parallel/
sharded.py:665-727`` (``_refine_window``, ``_local_refine``). In the JAX
package this is an XLA computation, not a Pallas kernel, so here it is plain
PyTorch on either device; a kernel that reads the candidates' codes and
nibbles in place is a later candidate (ROADMAP).

Each candidate's rows are rebuilt in f32 as ``doc_scale * c8 + res_scale *
c4`` (effectively 12-bit storage) and scored against the f32 queries. Only
the top ``max(32, 2k)`` int8 candidates of a query are re-scored, so the
hot kernels keep reading 1-byte codes. -1 candidates and 0-token docs score
``NEG_INF``: the kernels that feed the window never let a 0-token doc into
it, and the JAX fallback's 0 for one would outrank negative sums.
"""

from __future__ import annotations

from typing import Optional

import torch

from visual_rag_tpu_torch.index.store import unpack_int4
from visual_rag_tpu_torch.ops.kernels._checks import NEG_INF

# device-memory cap of one step's f32 candidate windows (sharded.py:707-709)
REFINE_BUDGET_BYTES = 128 * 1024 * 1024


def refine_window(k: int, limit: int) -> int:
    """Candidates re-scored per query: ``max(32, 2k)``, at most ``limit``
    (``sharded.py:665-669``)."""
    return max(1, min(limit, max(32, 2 * k)))


def refine_rerank(flat: torch.Tensor, res4: torch.Tensor, res_scales: torch.Tensor,
                  offsets: torch.Tensor, lengths: torch.Tensor, tokens: torch.Tensor,
                  qmask: torch.Tensor, candidates: torch.Tensor, max_len: int,
                  doc_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, K] f32 MaxSim of each query's candidates at int8 + int4 precision.

    ``flat`` int8 codes [N + pad, dim], ``res4`` uint8 [N + pad, dim // 2],
    ``res_scales`` f32 [N + pad], ``tokens`` [B, NQ, dim] (used in f32),
    ``qmask`` [B, NQ], ``candidates`` [B, K] (-1 = padding). The (query,
    candidate) pairs go in steps whose f32 windows stay under
    ``REFINE_BUDGET_BYTES``. Every step is one batched product of the same
    shape (the last is padded), so a pair's score depends neither on its
    position nor on its step: two_stage(prefetch >= corpus) and single_full
    re-score a doc to the same bits.
    """
    b, k = candidates.shape
    dev = flat.device
    t = max(1, int(max_len))
    ar = torch.arange(t, device=dev)
    total = b * k
    n_steps = max(1, -(-total // max(1, REFINE_BUDGET_BYTES // (t * flat.shape[1] * 4))))
    step = -(-total // n_steps)
    pad = n_steps * step - total
    cand = torch.cat([candidates.reshape(-1).long(),
                      torch.full((pad,), -1, dtype=torch.long, device=dev)])
    qrow = torch.cat([torch.arange(b, device=dev).repeat_interleave(k),  # query of each pair
                      torch.zeros((pad,), dtype=torch.long, device=dev)])
    valid = cand >= 0
    safe = cand.clamp(min=0)
    lens = torch.where(valid, lengths.long()[safe], 0)
    offs = offsets.long()[safe]
    scale = (doc_scales.float()[safe] if doc_scales is not None
             else torch.ones_like(safe, dtype=torch.float32))
    q, qm = tokens.float(), qmask.float()
    out = torch.empty((n_steps * step,), dtype=torch.float32, device=dev)
    for s in range(0, n_steps * step, step):
        sl = slice(s, s + step)
        idx = (offs[sl, None] + ar).clamp(max=flat.shape[0] - 1)  # [step, T]
        vals = flat[idx].float() * scale[sl, None, None]
        vals = vals + unpack_int4(res4[idx]).float() * res_scales[idx].float()[..., None]
        sims = torch.matmul(q[qrow[sl]], vals.transpose(1, 2))  # [step, NQ, T]
        sims = sims.masked_fill(~(ar < lens[sl, None])[:, None, :], NEG_INF)
        out[sl] = (sims.amax(dim=2) * qm[qrow[sl]]).sum(dim=1)
    out = torch.where(valid & (lens > 0), out, NEG_INF)
    return out[:total].reshape(b, k)
