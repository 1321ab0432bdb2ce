"""The port's query path end to end on the CPU vs the JAX package.

Both engines search the same sealed f32 index (the JAX synthetic index,
carried across with ``sealed_from_numpy``) with the same numpy queries:
``two_stage`` (prefetch below and at the corpus size) and ``single_full``,
on the padded wire and on the packed wire with the ``plain`` and ``scan``
reranks. The JAX engine runs with ``stage1_cut="exact"``, its Pallas kernels
replaced by their XLA fallbacks as on any CPU. Ids must agree under
``strict_rank_equal`` and scores within 1e-5 (f32 on both sides, summation
order differs). Serving: both the JAX package's ``SearchServer`` and the
port's answer ``POST /search`` over the port's engine.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from visual_rag_tpu.index.synth import synthetic_index as jax_synthetic_index
from visual_rag_tpu.retrieval import RetrievalEngine as JaxEngine
from visual_rag_tpu.serving.server import SearchServer as JaxSearchServer
from visual_rag_tpu_torch.index.convert import sealed_from_numpy
from visual_rag_tpu_torch.index.manifest import Manifest
from visual_rag_tpu_torch.index.store import SealedIndex
from visual_rag_tpu_torch.retrieval.engine import RetrievalEngine
from visual_rag_tpu_torch.retrieval.oracle import run_strict_oracle, strict_rank_equal
from visual_rag_tpu_torch.serving.server import SearchServer

torch.set_num_threads(1)  # tier-1 runs several test workers at once

N_DOCS = 100
TOL = 1e-5


@pytest.fixture(scope="module")
def indexes():
    j = jax_synthetic_index(N_DOCS, min_tokens=16, max_tokens=80, pooled_rows=4,
                            storage_dtype="float32", seed=3)
    stores = {
        "initial": {k: np.asarray(getattr(j.store("initial"), k))
                    for k in ("flat", "offsets", "lengths")} | {
            "max_len": j.store("initial").max_len},
        "mean_pooling": {"values": np.asarray(j.store("mean_pooling").values),
                         "mask": np.asarray(j.store("mean_pooling").mask)},
    }
    p = sealed_from_numpy(stores, j.manifest.ids, j.manifest.payloads, "float32", "cpu")
    return j, p


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(5)
    return [rng.standard_normal((int(rng.integers(8, 25)), 128)).astype(np.float32)
            for _ in range(24)]


def _same(jax_hits, port_hits, key):
    assert len(jax_hits) == len(port_hits)
    for jh, ph in zip(jax_hits, port_hits):
        assert strict_rank_equal([dict(h, score=h[key]) for h in jh], ph, score_tol=TOL)


@pytest.mark.parametrize("query_wire,rerank_impl", [
    ("padded", "auto"), ("packed", "plain"), ("packed", "scan")])
def test_two_stage_matches_jax(indexes, queries, query_wire, rerank_impl):
    j, p = indexes
    je = JaxEngine(j, stage1_cut="exact", query_wire=query_wire, rerank_impl=rerank_impl)
    pe = RetrievalEngine(p, query_wire=query_wire, rerank_impl=rerank_impl)
    for pk in (30, 200):  # 200 clamps to the corpus
        kw = dict(mode="two_stage", top_k=10, prefetch_k=pk, with_payload=False)
        _same(je.search_embedded_batch(queries, **kw),
              pe.search_embedded_batch(queries, **kw), "score_final")


@pytest.mark.parametrize("query_wire", ["padded", "packed"])
def test_single_full_matches_jax_and_two_stage(indexes, queries, query_wire):
    j, p = indexes
    je = JaxEngine(j, stage1_cut="exact", query_wire=query_wire)
    pe = RetrievalEngine(p, query_wire=query_wire)
    kw = dict(mode="single_full", top_k=10, with_payload=False)
    _same(je.search_embedded_batch(queries, **kw), pe.search_embedded_batch(queries, **kw),
          "score")
    assert run_strict_oracle(pe, queries, N_DOCS, score_tol=TOL)


def test_results_shape_and_payloads(indexes, queries):
    _, p = indexes
    pe = RetrievalEngine(p)
    res = pe.search_embedded_batch(queries[:3], top_k=5, prefetch_k=40)
    assert [len(r) for r in res] == [5, 5, 5]
    h = res[0][0]
    assert set(h) == {"id", "rank", "score_stage2", "score_final", "payload"}
    assert h["payload"] == {} and h["id"].startswith("d")
    arrs = pe.search_embedded_batch(queries[:3], top_k=5, prefetch_k=40,
                                    with_payload=False, return_arrays=True)
    assert arrs.to_dicts() == [[{k: x[k] for k in ("id", "rank", "score", "score_final")}
                                for x in [dict(hh, score=hh["score_final"]) for hh in r]]
                               for r in res]
    batches = [queries[:5], queries[5:7]]
    piped = list(pe.search_embedded_batches(batches, depth=2, with_payload=False))
    assert piped == [pe.search_embedded_batch(b, with_payload=False) for b in batches]


def test_top_k_is_clamped_to_the_corpus(indexes, queries):
    _, p = indexes
    pe = RetrievalEngine(p)
    for mode in ("two_stage", "single_full"):
        res = pe.search_embedded_batch(queries[:2], mode=mode, top_k=500, with_payload=False)
        assert [len(r) for r in res] == [N_DOCS, N_DOCS]


def test_empty_index_and_empty_batch(indexes, queries):
    empty = RetrievalEngine(SealedIndex(stores={}, manifest=Manifest()))
    assert empty.search_embedded_batch(queries[:3]) == [[], [], []]
    _, p = indexes
    assert RetrievalEngine(p).search_embedded_batch([]) == []


def test_refusals(indexes, queries):
    _, p = indexes
    pe = RetrievalEngine(p)
    with pytest.raises(ValueError, match="Unknown mode"):
        pe.search_embedded_batch(queries[:2], mode="nope")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pe.search_embedded_batch(queries[:2], mode="three_stage")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pe.search_embedded_batch(queries[:2], stage1_mode="tokens_vs_standard_pooling")
    with pytest.raises(ValueError, match="stage1_mode"):
        pe.search_embedded_batch(queries[:2], stage1_mode="nope")
    with pytest.raises(NotImplementedError, match="filters"):
        pe.search_embedded_batch(queries[:2], filter_obj=object())
    with pytest.raises(ValueError, match="with_payload"):
        pe.search_embedded_batch(queries[:2], return_arrays=True)
    for impl in ("dedup", "sweep"):
        with pytest.raises(NotImplementedError, match=impl):
            RetrievalEngine(p, rerank_impl=impl)
    # an explicit scan on the padded wire raises (no silent fallback)
    with pytest.raises(ValueError, match="packed query wire"):
        RetrievalEngine(p, rerank_impl="scan").search_embedded_batch(queries[:2])
    with pytest.raises(ValueError, match="query_wire"):
        RetrievalEngine(p, query_wire="f16")


def test_policies(indexes):
    _, p = indexes
    pe = RetrievalEngine(p)
    assert not pe._use_packed(256)  # the CPU keeps the padded wire
    assert RetrievalEngine(p, query_wire="packed")._use_packed(1)
    assert pe._rerank_impl(64, 10, packed=True) == "scan"  # 640 >= 4 * 100
    assert pe._rerank_impl(32, 10, packed=True) == "plain"
    assert pe._rerank_impl(256, 200, packed=False) == "plain"
    qs, n_real, b = RetrievalEngine._bucket_batch(list(range(33)))
    assert (n_real, b, len(qs)) == (33, 64, 64)
    assert RetrievalEngine._bucket_batch(list(range(300)))[2] == 512


@pytest.mark.parametrize("server_cls", [JaxSearchServer, SearchServer])
def test_search_server_over_the_port(indexes, queries, server_cls):
    _, p = indexes
    pe = RetrievalEngine(p)
    opts = {"mode": "two_stage", "top_k": 5, "prefetch_k": 40}
    direct = pe.search_embedded_batch(queries[:4], **opts)
    server = server_cls(pe, max_wait_ms=20.0).start()
    answers = [None] * 4
    try:
        def post(i):
            body = json.dumps({"embedding": queries[i].tolist(), **opts}).encode()
            req = urllib.request.Request(f"http://{server.host}:{server.port}/search",
                                         data=body)
            with urllib.request.urlopen(req, timeout=60) as resp:
                answers[i] = json.loads(resp.read())["results"]

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        with urllib.request.urlopen(f"http://{server.host}:{server.port}/healthz",
                                    timeout=10) as resp:
            assert json.loads(resp.read())["num_docs"] == N_DOCS
    finally:
        server.stop()
    for got, want in zip(answers, direct):
        assert [h["id"] for h in got] == [h["id"] for h in want]
        np.testing.assert_allclose([h["score_final"] for h in got],
                                   [h["score_final"] for h in want], rtol=0, atol=1e-6)
