"""The yardstick's arithmetic: the card's published peaks, a call's least
time, and the work a MaxSim batch and an attention call need.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``PEAK_OPS``, ``bound``,
``maxsim_bound`` and ``allowed_pair_count``), rewritten over plain numbers
so that a reader can apply them to the shapes a run recorded. The copies
stay here so that a later change to the program cannot move them.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

# the H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


def least_seconds(nbytes: float, ops: float, peak: str = "bf16") -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[peak])


def rerank_work(doc_lengths: Sequence[int], pair_q_rows: Iterable[Tuple[int, int]],
                dim: int, itemsize: int, b: int, nq: int, k: int) -> Tuple[float, float]:
    """(bytes, operations) of one exact rerank call (``maxsim_bound``'s
    ``rerank``): the rows of each distinct candidate doc read once, the
    queries [B, NQ, dim] f32, their mask [B, NQ] f32, the candidates
    [B, K] int32 read (twice, as the copy counts them) and the scores
    [B, K] f32 written; 2 * dim operations per (valid query row, doc row)
    pair. ``doc_lengths``: the lengths of the distinct candidates;
    ``pair_q_rows``: (valid query rows, doc length) of every valid pair."""
    rows = sum(int(n) for n in doc_lengths)
    ops = 2.0 * dim * sum(q * n for q, n in pair_q_rows)
    nbytes = rows * dim * itemsize + b * nq * dim * 4 + b * nq * 4 + 3 * b * k * 4
    return float(nbytes), ops


def pooled_stage1_work(valid_rows: int, rows: int, docs: int, dim: int, itemsize: int,
                       b: int) -> Tuple[float, float]:
    """(bytes, operations) of the pooled stage-1 of one batch: the pooled
    store [P, D, dim] and its mask [P, D] read once, the pooled queries
    [B, dim] f32 read and the scores [B, D] f32 written; 2 * dim operations
    per (query, valid pooled row)."""
    nbytes = rows * dim * itemsize + rows + b * dim * 4 + b * docs * 4
    return float(nbytes), 2.0 * dim * b * valid_rows


def allowed_pair_count(segment_lengths: Iterable[int], causal: bool) -> int:
    """Pairs (query i, key j) an attention computes over segments of these
    lengths: j in i's segment, and j <= i under causal (n(n + 1) / 2 for a
    segment of n)."""
    return sum(n * (n + 1) // 2 if causal else n * n for n in segment_lengths)


def attention_work(pairs: int, heads: int, kv_heads: int, dh: int, rows: int,
                   itemsize: int = 2, backward: bool = False) -> Tuple[float, float]:
    """(bytes, operations) of one attention call over ``rows`` tokens with
    ``pairs`` allowed (query, key) pairs a batch: q, k, v and the output read
    or written once (the backward: q, k, v, out, dout and lse read, dq, dk,
    dv written); 4 * dh operations per pair and head forward (S = QK^T and
    PV), 10 * dh backward (S again, dP, dS, dQ, dK, dV)."""
    q_bytes = rows * heads * dh * itemsize
    kv_bytes = 2 * rows * kv_heads * dh * itemsize
    if backward:
        nbytes = 2 * (q_bytes + kv_bytes) + 2 * q_bytes + rows * heads * 4
        return float(nbytes), 10.0 * dh * heads * pairs
    return float(q_bytes + kv_bytes + q_bytes), 4.0 * dh * heads * pairs
