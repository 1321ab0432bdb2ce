"""Strict exactness oracle: ``single_full`` against ``two_stage(prefetch >= corpus)``.

A copy of ``bench.py:109-153`` (``strict_rank_equal``, ``run_strict_oracle``);
importing ``bench.py`` would run its module body.
"""

from __future__ import annotations


def strict_rank_equal(exact_hits, wide_hits, score_tol=0.0):
    """True iff two top-k hit lists agree exactly, allowing reorderings only
    between entries whose scores tie (within ``score_tol``).

    exact_hits: hits with "score"; wide_hits: hits with "score_final".
    Conditions:
      1. same length, scores elementwise equal within score_tol;
      2. every id present in both lists carries the same score in both
         (within score_tol);
      3. ids appearing in only one list must ALL carry the boundary (last)
         score -- a tie group straddling the top-k cut is the one place two
         exact engines may legitimately surface different members.
    """
    if len(exact_hits) != len(wide_hits):
        return False
    s_ex = [float(h["score"]) for h in exact_hits]
    s_wd = [float(h.get("score_final", h.get("score"))) for h in wide_hits]
    if any(abs(a - b) > score_tol for a, b in zip(s_ex, s_wd)):
        return False
    ids_ex = [h["id"] for h in exact_hits]
    ids_wd = [h["id"] for h in wide_hits]
    by_ex = dict(zip(ids_ex, s_ex))
    by_wd = dict(zip(ids_wd, s_wd))
    for i in set(ids_ex) & set(ids_wd):
        if abs(by_ex[i] - by_wd[i]) > score_tol:
            return False
    diff = set(ids_ex) ^ set(ids_wd)
    if not diff:
        return True
    if not s_ex:
        return False
    boundary = s_ex[-1]
    return all(abs((by_ex.get(i) if i in by_ex else by_wd[i]) - boundary)
               <= score_tol for i in diff)


def run_strict_oracle(engine, queries, num_docs, score_tol=0.0, top_k=10):
    """single_full vs two_stage(prefetch=corpus) under strict_rank_equal."""
    exact = engine.search_embedded_batch(
        queries, mode="single_full", top_k=top_k, with_payload=False)
    wide = engine.search_embedded_batch(
        queries, mode="two_stage", top_k=top_k, prefetch_k=num_docs,
        with_payload=False)
    return all(strict_rank_equal(ex, wd, score_tol=score_tol)
               for ex, wd in zip(exact, wide))
