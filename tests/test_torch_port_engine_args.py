"""The port's engine takes the JAX engine's constructor arguments and ``warmup``.

The JAX ``RetrievalEngine(index, ..., compute_dtype, rerank_chunk,
stage1_cut, rerank_impl, query_wire, wire_dtype)`` and its ``warmup`` are
called by the JAX package's facade (``retrieval/facade.py:48-52``), the
ViDoRe harness (``benchmarks/run_tpu_beir.py:529-531``) and the serving
bench (``scripts/serving_bench.py:116``). On a tiny corpus sealed by both
packages' builders from the same vectors (f32), the same keyword arguments
build both engines, which then answer with the same ids (scores within
1e-5); ``warmup`` runs on both with the JAX signature and returns seconds.
The values the port refuses raise a ``ValueError`` naming why, and the two
environment variables refine only an ``"auto"`` argument.
"""

import numpy as np
import pytest
import torch

from visual_rag_tpu.index import CollectionSchema as JaxSchema
from visual_rag_tpu.index import IndexBuilder as JaxBuilder
from visual_rag_tpu.ops import colsmol_experimental_pooling, tile_level_mean_pooling
from visual_rag_tpu.retrieval import RetrievalEngine as JaxEngine
from visual_rag_tpu_torch.index.builder import CollectionSchema, IndexBuilder
from visual_rag_tpu_torch.retrieval.engine import RetrievalEngine
from visual_rag_tpu_torch.retrieval.oracle import strict_rank_equal

torch.set_num_threads(1)  # tier-1 runs several test workers at once


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(21)
    port = IndexBuilder(CollectionSchema.standard(storage_dtype="float32"))
    jax = JaxBuilder(JaxSchema.standard(storage_dtype="float32"))
    for i in range(24):
        tiles = int(rng.integers(2, 6))
        visual = rng.standard_normal((tiles * 64, 128)).astype(np.float32)
        mean = np.asarray(tile_level_mean_pooling(visual, tiles))
        vec = {"initial": visual, "mean_pooling": mean, "global_pooling": mean.mean(axis=0),
               "experimental_pooling": np.asarray(colsmol_experimental_pooling(visual, tiles))}
        port.add(f"p{i}", vec, {"year": 2020 + i % 3})
        jax.add(f"p{i}", vec, {"year": 2020 + i % 3})
    return port.seal(device="cpu"), jax.seal()


def _queries(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(6, 20)), 128)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("kw", [
    # the facade's call (retrieval/facade.py:48-52)
    dict(experimental_vector_name="experimental_pooling", compute_dtype=None),
    # the ViDoRe harness's (benchmarks/run_tpu_beir.py:529-531)
    dict(stage1_cut="exact"),
    dict(compute_dtype="float32", rerank_chunk=64, stage1_cut="auto", rerank_impl="plain",
         query_wire="padded", wire_dtype="f32"),
])
def test_the_same_arguments_build_both_engines(indexes, kw):
    port_idx, jax_idx = indexes
    port, jax = RetrievalEngine(port_idx, **kw), JaxEngine(jax_idx, **kw)
    assert port.compute_dtype == jax.compute_dtype == "float32"
    assert port.rerank_chunk == jax.rerank_chunk
    qs = _queries(1, 6)
    for mode in ("two_stage", "single_full", "three_stage"):
        search = dict(mode=mode, top_k=5, prefetch_k=10, stage1_k=12, stage2_k=8,
                      with_payload=False)
        key = "score" if mode == "single_full" else "score_final"
        for a, b in zip(port.search_embedded_batch(qs, **search),
                        jax.search_embedded_batch(qs, **search)):
            assert strict_rank_equal([dict(h, score=h[key]) for h in b], a, score_tol=1e-5)


def test_warmup_runs_with_the_jax_signature(indexes):
    port_idx, jax_idx = indexes
    for engine in (RetrievalEngine(port_idx, compute_dtype=None), JaxEngine(jax_idx)):
        seconds = engine.warmup(modes=("two_stage", "single_full"), batch_sizes=(1, 4),
                                n_query_tokens=12, prefetch_k=10)
        assert isinstance(seconds, float) and seconds >= 0.0
    assert RetrievalEngine(port_idx).warmup() >= 0.0  # the defaults: two_stage at bs 1 and 64


@pytest.mark.parametrize("kw,match", [
    (dict(compute_dtype="bfloat16"), "compute_dtype.*declared difference"),
    (dict(compute_dtype="float16"), "compute_dtype"),
    (dict(stage1_cut="approx"), "stage1_cut='approx'.*declared difference"),
    (dict(stage1_cut="fast"), "stage1_cut must be"),
    (dict(wire_dtype="f16"), "wire_dtype='f16'.*declared difference"),
    (dict(wire_dtype="f8"), "wire_dtype must be"),
    (dict(query_wire="ragged"), "query_wire must be"),
    (dict(rerank_impl="fast"), "rerank_impl must be"),
])
def test_refused_values_raise_by_name(indexes, kw, match):
    with pytest.raises(ValueError, match=match):
        RetrievalEngine(indexes[0], **kw)


def test_environment_refines_only_the_auto_arguments(indexes, monkeypatch):
    idx = indexes[0]
    monkeypatch.setenv("VISUALRAG_QUERY_WIRE", "packed")
    assert RetrievalEngine(idx).query_wire == "packed"
    assert RetrievalEngine(idx, query_wire="padded").query_wire == "padded"
    monkeypatch.setenv("VISUALRAG_WIRE_DTYPE", "f32")
    assert RetrievalEngine(idx).wire_dtype == "f32"
    monkeypatch.setenv("VISUALRAG_WIRE_DTYPE", "f16")
    with pytest.raises(ValueError, match="wire_dtype='f16'"):
        RetrievalEngine(idx)
    assert RetrievalEngine(idx, wire_dtype="f32").wire_dtype == "f32"
