"""Stage-2 rerank by a sweep over row ranges of the store (K4).

Port of ``visual_rag_tpu/ops/kernels/maxsim_sweep.py``: ``_ceil32``
(``:59-60``, as ``_checks.ceil32``) and :func:`sweep_params` (``:148-160``)
as they are, the pair bookkeeping of ``rerank_candidates_sweep``
(``:206-320``) as :func:`sweep_layout`, and the kernel as
``csrc/maxsim_sweep.cu``. The store is cut into ranges of ``r_step`` rows;
the flattened (query,
candidate) pairs sort by (range of the doc's first row, query), -1,
out-of-range and 0-token pairs past every range (``:241``); each pair gets
its window counted from its range's first row, and the scores land back
through the sort permutation (``:353-357``). The range only decides which
pairs share a pass over the store; it never changes a score, which is K2's.

:func:`sweep_supported` states the CUDA kernel's own envelope. The TPU's
VMEM and SMEM budgets (``:172-187``), its 256-query qid bit-pack
(``:51-56``) and the ``lax.map`` chunking above it
(``parallel/sharded.py:458-471``) were TPU workarounds and are gone.

On a CUDA tensor :func:`rerank_candidates_sweep` launches the kernel; on a
CPU tensor it runs :func:`rerank_candidates_sweep_ref`, which goes through
the same layout and scores each sorted pair in f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from visual_rag_tpu_torch.ops.kernels import _build
from visual_rag_tpu_torch.ops.kernels._checks import (
    DTYPE_CODES,
    NEG_INF,
    ceil32,
    on_cpu,
    ptr,
    stream_ptr,
)
from visual_rag_tpu_torch.ops.kernels.maxsim_rerank import (
    check_rerank_args,
    pair_kernels_fit,
    pair_scores,
)

SWEEP_R_STEP = 512  # the engine's range step (parallel/sharded.py:421)


def sweep_params(rows: int, max_len: int, r_step: int = 2048):
    """(r_step, r_rows, n_ranges) for a store of ``rows`` flat rows.

    Small stores collapse to a single whole-store window; otherwise ranges
    step by ``r_step`` (raised to the doc span if docs are longer) with a
    one-span overlap so every doc starting inside a step fits its window.
    """
    span = ceil32(max_len)
    r_step = max(int(r_step), span)
    if rows <= r_step + span:
        return rows, rows, 1  # single range covers the whole store
    r_rows = r_step + span
    return r_step, r_rows, -(-rows // r_step)


def sweep_supported(rows: int, max_len: int, b: int, k: int, nq: int, dim: int,
                    itemsize: int) -> bool:
    """Whether K4 takes this geometry: the query fits the block's shared
    memory beside a tile of the store, and the pair count the kernel's int32
    indexing. No limit on rows, ``max_len`` or the batch: the kernel streams
    each window in tiles."""
    return rows > 0 and b * k < 2**31 and pair_kernels_fit(itemsize, dim, nq)


def sweep_layout(candidates, offsets, lengths, rows: int, max_len: int, doc_scales=None,
                 r_step: int = SWEEP_R_STEP):
    """K4's bookkeeping, on the candidates' device and without a wait for it.

    Returns a dict of int32 tensors (``pair_scale`` f32 or None) and
    ``n_ranges``: ``order`` (sorted pair j is flat [B*K] index
    ``order[j]``), ``pair_start`` [n_ranges + 1] (the first sorted pair of
    each range; ``pair_start[n_ranges]`` counts the live pairs, the rest are
    dead), ``range_start`` [n_ranges] (each range's first row, clamped so
    its ``r_rows`` window stays in the store), and per sorted pair its query
    ``pair_q``, its window's first row counted from its range's
    ``pair_off``, ``pair_len`` and ``pair_scale``.
    """
    r_step, r_rows, n_ranges = sweep_params(rows, max_len, r_step)
    dev = candidates.device
    b, k = candidates.shape
    flat = candidates.reshape(-1).long()
    valid = (flat >= 0) & (flat < offsets.shape[0])
    safe = torch.where(valid, flat, 0)
    off = torch.where(valid, offsets.long()[safe], 0)
    ln = torch.where(valid, lengths.long()[safe], 0)
    qid = torch.arange(flat.numel(), device=dev) // max(1, k)
    rid = torch.where(valid & (ln > 0), off // r_step, n_ranges)
    order = torch.sort(rid * b + qid, stable=True).indices
    srid = rid[order]
    pair_start = torch.searchsorted(srid, torch.arange(n_ranges + 1, device=dev))
    range_start = (torch.arange(n_ranges, device=dev) * r_step).clamp(max=rows - r_rows)
    live = srid < n_ranges
    sloff = torch.where(live, off[order] - range_start[srid.clamp(max=n_ranges - 1)], 0)
    return {
        "n_ranges": n_ranges,
        "order": order.to(torch.int32),
        "pair_start": pair_start.to(torch.int32),
        "range_start": range_start.to(torch.int32),
        "pair_q": qid[order].to(torch.int32),
        "pair_off": sloff.to(torch.int32),
        "pair_len": ln[order].to(torch.int32),
        "pair_scale": None if doc_scales is None else doc_scales[safe][order].float().contiguous(),
    }


def rerank_candidates_sweep(
    flat: torch.Tensor,  # [rows, dim] ragged store (f32/bf16/f16/int8 codes)
    offsets: torch.Tensor,  # [D] int32
    lengths: torch.Tensor,  # [D] int32
    queries: torch.Tensor,  # [B, NQ, dim] l2-normalised tokens
    qmask: torch.Tensor,  # [B, NQ] 0/1 (bool or float)
    candidates: torch.Tensor,  # [B, K] doc ids, -1 = padding
    max_len: int,
    doc_scales: Optional[torch.Tensor] = None,  # [D] f32 per-doc scales
    r_step: int = SWEEP_R_STEP,
) -> torch.Tensor:
    """K2's scores [B, K] f32 by a sweep over row ranges (K4): one block per
    range, which passes over the rows its pairs' windows cover once a group
    of 16 pairs."""
    if on_cpu(flat):
        return rerank_candidates_sweep_ref(flat, offsets, lengths, queries, qmask,
                                           candidates, max_len, doc_scales, r_step)
    q, qm, cand = check_rerank_args(flat, offsets, lengths, queries, qmask, candidates,
                                    doc_scales)
    (b, nq, dim), k = queries.shape, candidates.shape[1]
    rows = flat.shape[0]
    if not sweep_supported(rows, max_len, b, k, nq, dim, flat.element_size()):
        raise ValueError(f"the sweep kernel does not take {nq}-token queries over "
                         f"{rows} rows of dim {dim} ({b} x {k} pairs)")
    out = torch.full((b * k,), NEG_INF, dtype=torch.float32, device=flat.device)
    if b == 0 or k == 0:
        return out.view(b, k)
    lay = sweep_layout(cand, offsets, lengths, rows, max_len, doc_scales, r_step)
    lib = _build.load_library()
    err = lib.vrt_rerank_candidates_sweep(
        flat.device.index, ptr(flat), DTYPE_CODES[flat.dtype], ptr(q), DTYPE_CODES[q.dtype],
        ptr(qm), nq, dim, lay["n_ranges"], ptr(lay["range_start"]), ptr(lay["pair_start"]),
        ptr(lay["pair_q"]), ptr(lay["pair_off"]), ptr(lay["pair_len"]), ptr(lay["order"]),
        ptr(lay["pair_scale"]), ptr(out), stream_ptr(flat.device))
    _build.check(err, "rerank_candidates_sweep launch")
    rerank_candidates_sweep.launches += 1
    return out.view(b, k)


rerank_candidates_sweep.launches = 0


def rerank_candidates_sweep_ref(flat, offsets, lengths, queries, qmask, candidates,
                                max_len: int, doc_scales=None,
                                r_step: int = SWEEP_R_STEP) -> torch.Tensor:
    """Plain PyTorch version of :func:`rerank_candidates_sweep`, through the
    kernel's own layout: sorted pair j reads rows from ``range_start[r] +
    pair_off[j]`` where r is the range that ``pair_start`` puts it in (as
    the block reads them), with query ``pair_q[j]``, and the scores scatter
    back through ``order``. A wrong range boundary, local offset or
    permutation shows as a wrong score."""
    b, k = candidates.shape
    total = b * k
    lay = sweep_layout(candidates, offsets, lengths, flat.shape[0], max_len, doc_scales,
                       r_step)
    n_ranges = lay["n_ranges"]
    pos = torch.arange(total, dtype=torch.int32, device=flat.device)
    rng = torch.searchsorted(lay["pair_start"], pos, right=True) - 1  # n_ranges: dead
    live = rng < n_ranges
    row0 = lay["range_start"][rng.clamp(max=n_ranges - 1).long()].long() + lay["pair_off"]
    lens = torch.where(live, lay["pair_len"], 0)
    scores = pair_scores(flat, row0, lens, queries, qmask, lay["pair_q"], max_len,
                         lay["pair_scale"])
    out = torch.full((total,), NEG_INF, dtype=torch.float32, device=flat.device)
    out[lay["order"].long()] = scores
    return out.view(b, k)
