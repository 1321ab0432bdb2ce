"""The port's engine over int8 and int8_refined stores vs the JAX engine, on the CPU.

Both engines search the same JAX ``IndexBuilder`` seal (all four stores,
pooled stores padded with invalid rows, payloads), carried across with
``sealed_from_numpy``; the JAX engine runs with ``compute_dtype="float32"``
and ``stage1_cut="exact"``, its Pallas kernels replaced by their XLA
fallbacks as on any CPU. Every search mode, every stage-1 mode and alias,
filters and per-query ``search_embedded``, on both wires.

Tolerances:
- ``int8_refined``: the final scores come from the refine pass, f32 queries
  on both sides, so ids agree under ``strict_rank_equal`` and scores to
  ``TOL`` = 1e-5. ``single_*`` modes and the stage-1/stage-2 columns of
  ``three_stage`` round the same way on both sides too.
- plain ``int8``, ``two_stage`` and ``three_stage``: the JAX CPU fallbacks
  of its reranks (``plain``, ``dedup``, ``sweep``) rerank with f32 queries
  (``batch.py:473-479``) where its TPU kernel and the port round them to
  bf16 (``maxsim_rerank.py:171``, a declared difference). A bf16 query
  element is off by at most 2**-9 of itself, so a unit-norm token's dot
  with a unit-norm row moves by at most 2**-9; over 24 tokens at most
  24 * 2**-9 ~ 0.047. Scores must agree to ``TOL_BF16`` = 24 * 2**-9 and
  ids under ``strict_rank_equal`` at that tolerance: they may swap only
  where the JAX scores lie within it.
"""

import numpy as np
import pytest
import torch

from visual_rag_tpu.index import CollectionSchema, IndexBuilder
from visual_rag_tpu.retrieval import RetrievalEngine as JaxEngine
from visual_rag_tpu.retrieval import build_filter as jax_build_filter
from visual_rag_tpu_torch.index.quantize import quantize_index
from visual_rag_tpu_torch.retrieval.engine import (
    _STAGE1_ALIASES,
    SEARCH_MODES,
    STAGE1_MODES,
    RetrievalEngine,
)
from visual_rag_tpu_torch.retrieval.filters import build_filter
from visual_rag_tpu_torch.retrieval.local import rerank_route
from visual_rag_tpu_torch.retrieval.oracle import run_strict_oracle, strict_rank_equal
from test_torch_port_int8 import build_jax, carried

torch.set_num_threads(1)  # tier-1 runs several test workers at once

DIM = 128
TOL = 1e-5
TOL_BF16 = 24 * 2.0 ** -9  # 24 query tokens, each dot off by <= 2**-9 (module docstring)
CUTS = dict(top_k=5, prefetch_k=12, stage1_k=20, stage2_k=12)
DTYPES = ("int8", "int8_refined")


@pytest.fixture(scope="module")
def pairs():
    """(JAX seal, port index) per int8 dtype, one corpus."""
    return {dt: (j, carried(j, dt)) for dt in DTYPES for j in [build_jax(dt)]}


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(5)
    return [rng.standard_normal((int(rng.integers(8, 25)), DIM)).astype(np.float32)
            for _ in range(24)]


def _engines(pairs, dt, query_wire):
    j, p = pairs[dt]
    return (JaxEngine(j, compute_dtype="float32", stage1_cut="exact", query_wire=query_wire),
            RetrievalEngine(p, query_wire=query_wire))


def _tol(dt, mode):
    """TOL_BF16 where plain int8's final scores come from a rerank."""
    return TOL_BF16 if dt == "int8" and mode in ("two_stage", "three_stage") else TOL


def _same_hits(jax_hits, port_hits, key, tol, cols=()):
    """Ids under strict_rank_equal on ``key`` at ``tol``; every score column
    in ``cols`` of a hit both return within TOL."""
    assert len(jax_hits) == len(port_hits)
    for jh, ph in zip(jax_hits, port_hits):
        assert strict_rank_equal([dict(h, score=h[key]) for h in jh], ph, score_tol=tol)
        by_id = {h["id"]: h for h in ph}
        for h in jh:
            for col in cols:
                if h["id"] in by_id:
                    assert abs(h[col] - by_id[h["id"]][col]) <= TOL, (col, h, by_id[h["id"]])


@pytest.mark.parametrize("query_wire", ["padded", "packed"])
@pytest.mark.parametrize("mode", SEARCH_MODES)
@pytest.mark.parametrize("dt", DTYPES)
def test_every_mode_matches_jax(pairs, queries, dt, mode, query_wire):
    je, pe = _engines(pairs, dt, query_wire)
    kw = dict(mode=mode, with_payload=False, **CUTS)
    key = "score" if mode.startswith("single_") else "score_final"
    cols = ("score_stage1", "score_stage2") if mode == "three_stage" else ()
    got = pe.search_embedded_batch(queries, **kw)
    assert all(len(hits) == CUTS["top_k"] for hits in got)
    _same_hits(je.search_embedded_batch(queries, **kw), got, key, _tol(dt, mode), cols)


@pytest.mark.parametrize("query_wire", ["padded", "packed"])
@pytest.mark.parametrize("stage1_mode", STAGE1_MODES + tuple(_STAGE1_ALIASES))
@pytest.mark.parametrize("dt", DTYPES)
def test_every_stage1_mode_matches_jax(pairs, queries, dt, stage1_mode, query_wire):
    """The tokens stage-1 modes run the qdot body on these int8 pooled stores."""
    je, pe = _engines(pairs, dt, query_wire)
    kw = dict(mode="two_stage", stage1_mode=stage1_mode, with_payload=False, **CUTS)
    _same_hits(je.search_embedded_batch(queries, **kw), pe.search_embedded_batch(queries, **kw),
               "score_final", _tol(dt, "two_stage"))


@pytest.mark.parametrize("dt", DTYPES)
def test_filter_matches_jax(pairs, queries, dt):
    je, pe = _engines(pairs, dt, "padded")
    spec = dict(year=[2020, 2023], source="a")
    for mode in ("two_stage", "single_full", "three_stage"):
        kw = dict(mode=mode, **CUTS)
        key = "score" if mode == "single_full" else "score_final"
        got = pe.search_embedded_batch(queries, filter_obj=build_filter(**spec), **kw)
        _same_hits(je.search_embedded_batch(queries, filter_obj=jax_build_filter(**spec), **kw),
                   got, key, _tol(dt, mode))
        for hits in got:
            assert all(h["payload"]["year"] in (2020, 2023) and h["payload"]["source"] == "a"
                       for h in hits)


@pytest.mark.parametrize("dt", DTYPES)
def test_search_embedded_equals_the_batch(pairs, queries, dt):
    """Per-query ``search_embedded`` (a padded batch of one: K7, and K7's
    qdot entry point for the tokens stage-1) gives the batch's hits, which
    the tests above hold against the JAX engine's batch. (The JAX engine's
    own per-query path is separate code that scores int8 stores with f32
    queries in places; it is not the reference here.)"""
    _, pe = _engines(pairs, dt, "padded")
    runs = [dict(mode=m) for m in SEARCH_MODES] + [
        dict(mode="two_stage", stage1_mode="tokens_vs_standard_pooling")]
    for run in runs:
        kw = dict(run, with_payload=False, **CUTS)
        key = "score" if run["mode"].startswith("single_") else "score_final"
        batch = pe.search_embedded_batch(queries[:4], **kw)
        for q, hits in zip(queries[:4], batch):
            one = pe.search_embedded(q, **kw)
            assert [h["id"] for h in one] == [h["id"] for h in hits], run
            np.testing.assert_allclose([h[key] for h in one], [h[key] for h in hits],
                                       rtol=0, atol=TOL)


def test_refined_three_stage_columns(pairs, queries):
    """``three_stage`` on int8_refined: the winners come from the refine
    window, each winner's stage-2 score is found by id (trap 6); all four
    columns agree with JAX at TOL."""
    je, pe = _engines(pairs, "int8_refined", "padded")
    kw = dict(mode="three_stage", with_payload=False, top_k=8, stage1_k=25, stage2_k=20)
    got = pe.search_embedded_batch(queries, **kw)
    want = je.search_embedded_batch(queries, **kw)
    _same_hits(want, got, "score_final", TOL, ("score_stage1", "score_stage2"))
    for hits in got:
        assert [h["score_final"] for h in hits] == sorted((h["score_final"] for h in hits),
                                                          reverse=True)
        assert all(h["score_stage3"] == h["score_final"] for h in hits)
    # the refine reorders: some winner's stage-2 rank differs from its final rank
    assert any([h["score_stage2"] for h in hits] != sorted((h["score_stage2"] for h in hits),
                                                           reverse=True) for hits in got)


@pytest.mark.parametrize("query_wire", ["padded", "packed"])
def test_refined_strict_oracle_on_cpu(pairs, queries, query_wire):
    """two_stage(prefetch = corpus) equals single_full on int8_refined: both
    refine the same window and a doc's refined score does not depend on its
    position (tolerance 0)."""
    _, pe = _engines(pairs, "int8_refined", query_wire)
    assert run_strict_oracle(pe, queries, pe.index.num_docs, score_tol=0.0)


def test_plain_int8_rerank_differs_from_jax_cpu_within_the_stated_tolerance(pairs, queries):
    """Trap 4 pinned: on plain int8 the port's rerank (bf16 queries, as the
    TPU kernel) and the JAX CPU fallback's (f32 queries) differ, by more
    than f32 rounding and by at most TOL_BF16."""
    je, pe = _engines(pairs, "int8", "padded")
    kw = dict(mode="two_stage", top_k=10, prefetch_k=30, with_payload=False)
    assert rerank_route(pe._fused_arrays("initial"), pe.index.num_docs, 32, 30, False) == "plain"
    want = je.search_embedded_batch(queries, **kw)
    got = pe.search_embedded_batch(queries, **kw)
    diffs = []
    for jh, ph in zip(want, got):
        by_id = {h["id"]: h["score_final"] for h in ph}
        diffs += [abs(h["score_final"] - by_id[h["id"]]) for h in jh if h["id"] in by_id]
    assert 1e-5 < max(diffs) <= TOL_BF16, max(diffs)
    _same_hits(want, got, "score_final", TOL_BF16)


def _clustered_points(rng, n_docs=300, clusters=12, spread=0.35):
    """Mildly clustered corpus, near-ties without pure noise (as
    ``test_int8_refined.py:19-38``)."""
    centers = rng.standard_normal((clusters, DIM)).astype(np.float32)
    points = []
    for i in range(n_docs):
        toks = (centers[i % clusters][None]
                + spread * rng.standard_normal((int(rng.integers(24, 64)), DIM))).astype(np.float32)
        mp = toks[:min(8, len(toks))].copy()
        points.append({"id": f"doc{i}", "payload": {"i": i},
                       "vectors": {"initial": toks, "mean_pooling": mp,
                                   "global_pooling": toks.mean(axis=0),
                                   "experimental_pooling": mp}})
    return points, centers


def test_refined_overlap_with_bf16_is_at_least_int8s():
    """The port's refined top-10 overlaps the bf16 engine's at least as much
    as plain int8's does (``test_int8_refined.py:91-107``), on int8 indexes
    the port quantizes itself from the f32 seal."""
    rng = np.random.default_rng(7)
    points, centers = _clustered_points(rng)
    queries = [(centers[i % len(centers)][None] + 0.5 * rng.standard_normal((12, DIM)))
               .astype(np.float32) for i in range(24)]
    seal = {}
    for dt in ("float32", "bfloat16"):
        b = IndexBuilder(CollectionSchema.standard(storage_dtype=dt, dim=DIM))
        b.upload_batch(points)
        seal[dt] = carried(b.seal(), dt)
    kw = dict(mode="two_stage", top_k=10, prefetch_k=100, with_payload=False)
    top = {dt: [{h["id"] for h in hits} for hits in RetrievalEngine(
        idx).search_embedded_batch(queries, **kw)]
        for dt, idx in (("bfloat16", seal["bfloat16"]),
                        ("int8", quantize_index(seal["float32"], "int8")),
                        ("int8_refined", quantize_index(seal["float32"], "int8_refined")))}
    overlap = {dt: np.mean([len(a & b) / 10 for a, b in zip(top["bfloat16"], top[dt])])
               for dt in DTYPES}
    assert overlap["int8_refined"] >= overlap["int8"] - 1e-9, overlap
    assert overlap["int8_refined"] >= 0.98, overlap
