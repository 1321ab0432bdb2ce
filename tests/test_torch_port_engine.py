"""The port's query path end to end on the CPU vs the JAX package.

Both engines search the same sealed f32 index, carried across with
``sealed_from_numpy``, with the same numpy queries. Two indexes: the JAX
synthetic index (``initial`` and ``mean_pooling``, all pooled rows valid)
for ``two_stage`` and ``single_full`` on the padded wire and on the packed
wire with the ``plain`` and ``scan`` reranks; and an index built with the
JAX ``IndexBuilder`` as the verify recipe builds one (all four stores, the
pooled stores padded with invalid rows, ``year``/``source`` payloads) for
every search mode, every stage-1 mode and alias, payload filters and the
per-query ``search_embedded``. The CPU engine's transfer path: pipelined
batches equal single ones, a yielded result is never overwritten, and no
batch is counted as pinned, also from many threads. The JAX engine runs with
``stage1_cut="exact"``, its Pallas kernels replaced by their XLA fallbacks
as on any CPU. Ids must agree under ``strict_rank_equal`` and scores within
1e-5 (f32 on both sides, summation order differs). Serving: both the JAX
package's ``SearchServer`` and the port's answer ``POST /search`` over the
port's engine.
"""

import copy
import json
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from visual_rag_tpu import IndexBuilder
from visual_rag_tpu.index import CollectionSchema
from visual_rag_tpu.index.synth import synthetic_index as jax_synthetic_index
from visual_rag_tpu.ops import (
    colsmol_experimental_pooling,
    global_mean_pooling,
    tile_level_mean_pooling,
)
from visual_rag_tpu.retrieval import RetrievalEngine as JaxEngine
from visual_rag_tpu.retrieval import build_filter as jax_build_filter
from visual_rag_tpu.serving.server import SearchServer as JaxSearchServer
from visual_rag_tpu_torch.index.convert import sealed_from_numpy
from visual_rag_tpu_torch.index.manifest import Manifest
from visual_rag_tpu_torch.index.store import SealedIndex
from visual_rag_tpu_torch.retrieval.engine import (
    _STAGE1_ALIASES,
    SEARCH_MODES,
    STAGE1_MODES,
    RetrievalEngine,
)
from visual_rag_tpu_torch.retrieval.filters import PayloadFilter, build_filter
from visual_rag_tpu_torch.retrieval.local import rerank_route
from visual_rag_tpu_torch.retrieval.oracle import run_strict_oracle, strict_rank_equal
from visual_rag_tpu_torch.serving.server import SearchServer

torch.set_num_threads(1)  # tier-1 runs several test workers at once

N_DOCS = 100
N_BUILT = 30
TOL = 1e-5
# small enough that every stage cuts: stage-1 12 of 30 docs, three_stage 20 -> 12
CUTS = dict(top_k=5, prefetch_k=12, stage1_k=20, stage2_k=12)


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


def _numpy_stores(index):
    """The arrays of a JAX SealedIndex's stores, as ``sealed_from_numpy`` takes them."""
    out = {}
    for name in index.vector_names:
        st = index.store(name)
        if hasattr(st, "flat"):
            out[name] = {k: np.asarray(getattr(st, k)) for k in ("flat", "offsets", "lengths")}
            out[name]["max_len"] = st.max_len
        elif hasattr(st, "mask"):
            out[name] = {"values": np.asarray(st.values), "mask": np.asarray(st.mask)}
        else:
            out[name] = {"values": np.asarray(st.values)}
    return out


@pytest.fixture(scope="module")
def built():
    """JAX IndexBuilder index of every store (f32), carried across."""
    rng = np.random.default_rng(11)
    b = IndexBuilder(CollectionSchema.standard(storage_dtype="float32"))
    for i in range(N_BUILT):
        tiles = int(rng.integers(2, 6))
        t = rng.standard_normal((tiles * 64 + int(rng.integers(0, 20)), 128)).astype(np.float32)
        mp = np.asarray(tile_level_mean_pooling(t, tiles))
        b.add(f"p{i}", {"initial": t, "mean_pooling": mp,
                        "experimental_pooling": np.asarray(colsmol_experimental_pooling(t, tiles)),
                        "global_pooling": np.asarray(global_mean_pooling(mp))},
              {"year": 2020 + i % 4, "source": "ab"[i % 2]})
    j = b.seal()
    assert not np.asarray(j.store("mean_pooling").mask).all()  # invalid pooled rows
    assert not np.asarray(j.store("experimental_pooling").mask).all()
    p = sealed_from_numpy(_numpy_stores(j), j.manifest.ids, j.manifest.payloads,
                          "float32", "cpu")
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
    """What the port still refuses: unknown modes and reranks, scan on the
    padded wire, int8 codes without their scales, an unknown storage dtype.
    Each raises. (Explicit dedup/sweep reranks are served: on the CPU
    through their plain versions.)"""
    _, p = indexes
    pe = RetrievalEngine(p)
    with pytest.raises(ValueError, match="Unknown mode"):
        pe.search_embedded_batch(queries[:2], mode="nope")
    with pytest.raises(ValueError, match="Unknown mode"):
        pe.search_embedded(queries[0], mode="nope")
    with pytest.raises(ValueError, match="stage1_mode"):
        pe.search_embedded_batch(queries[:2], stage1_mode="nope")
    with pytest.raises(ValueError, match="with_payload"):
        pe.search_embedded_batch(queries[:2], return_arrays=True)
    kw = dict(top_k=5, prefetch_k=40, with_payload=False)
    plain = RetrievalEngine(p, rerank_impl="plain").search_embedded_batch(queries[:2], **kw)
    for impl in ("dedup", "sweep"):
        got = RetrievalEngine(p, rerank_impl=impl).search_embedded_batch(queries[:2], **kw)
        for g, w in zip(got, plain):
            assert strict_rank_equal([dict(h, score=h["score_final"]) for h in w], g,
                                     score_tol=TOL)
    with pytest.raises(ValueError, match="rerank_impl"):
        RetrievalEngine(p, rerank_impl="nope")
    # an explicit scan on the padded wire raises (no silent fallback)
    with pytest.raises(ValueError, match="packed query wire"):
        RetrievalEngine(p, rerank_impl="scan").search_embedded_batch(queries[:2])
    with pytest.raises(ValueError, match="query_wire"):
        RetrievalEngine(p, query_wire="f16")
    # int8 stores enter the port with their scales (tests/test_torch_port_int8*.py);
    # codes without them, or an unknown storage dtype, are refused
    int8 = {"initial": {"flat": np.zeros((32, 128), np.int8), "offsets": np.zeros(1, np.int32),
                        "lengths": np.ones(1, np.int32), "max_len": 1}}
    with pytest.raises(ValueError, match="int8 codes without their scales"):
        sealed_from_numpy(int8, ["a"], [{}], "int8", "cpu")
    with pytest.raises(ValueError, match="storage dtype"):
        sealed_from_numpy({}, [], [], "int4", "cpu")


def _pair(built, query_wire):
    j, p = built
    return (JaxEngine(j, stage1_cut="exact", query_wire=query_wire),
            RetrievalEngine(p, query_wire=query_wire))


def _same_hits(jax_hits, port_hits, key, cols=()):
    """Ids under strict_rank_equal on ``key``; every other score column of
    a hit both return within TOL."""
    _same(jax_hits, port_hits, key)
    for jh, ph in zip(jax_hits, port_hits):
        by_id = {h["id"]: h for h in ph}
        for h in jh:
            if h["id"] in by_id:
                for col in cols:
                    assert abs(h[col] - by_id[h["id"]][col]) <= TOL, (col, h, by_id[h["id"]])


@pytest.mark.parametrize("query_wire", ["padded", "packed"])
@pytest.mark.parametrize("mode", SEARCH_MODES)
def test_every_mode_matches_jax(built, queries, mode, query_wire):
    je, pe = _pair(built, query_wire)
    kw = dict(mode=mode, with_payload=False, **CUTS)
    key = "score" if mode.startswith("single_") else "score_final"
    cols = ("score_stage1", "score_stage2") if mode == "three_stage" else ()
    got = pe.search_embedded_batch(queries, **kw)
    assert all(len(hits) == CUTS["top_k"] for hits in got)
    _same_hits(je.search_embedded_batch(queries, **kw), got, key, cols)


@pytest.mark.parametrize("query_wire", ["padded", "packed"])
@pytest.mark.parametrize("stage1_mode", STAGE1_MODES + tuple(_STAGE1_ALIASES))
def test_every_stage1_mode_matches_jax(built, queries, stage1_mode, query_wire):
    je, pe = _pair(built, query_wire)
    kw = dict(mode="two_stage", stage1_mode=stage1_mode, with_payload=False, **CUTS)
    _same_hits(je.search_embedded_batch(queries, **kw),
               pe.search_embedded_batch(queries, **kw), "score_final")


FILTERS = {
    "scalar": dict(year=2021),
    "list": dict(year=[2020, 2023], source="a"),
    "ids": dict(ids=["p3", "p8", "p13", "p21", "p22", "p29", "nope"]),
    "nothing": dict(year=1999),
}


def _filters(case):
    """(JAX filter, port filter) of one case."""
    spec = dict(FILTERS[case])
    if "ids" in spec:
        from visual_rag_tpu.retrieval.filters import PayloadFilter as JaxPayloadFilter

        return JaxPayloadFilter(ids=spec["ids"]), PayloadFilter(ids=spec["ids"])
    return jax_build_filter(**spec), build_filter(**spec)


def _admits(spec, hit_id, payload):
    if "ids" in spec:
        return hit_id in spec["ids"]
    return all(payload[f] in (v if isinstance(v, list) else [v]) for f, v in spec.items())


@pytest.mark.parametrize("case", sorted(FILTERS))
def test_filters_match_jax(built, queries, case):
    je, pe = _pair(built, "padded")
    jf, pf = _filters(case)
    for mode in ("two_stage", "single_full", "three_stage"):
        kw = dict(mode=mode, **CUTS)
        key = "score" if mode == "single_full" else "score_final"
        want = je.search_embedded_batch(queries, filter_obj=jf, **kw)
        for f in (pf, jf):  # the port takes the JAX package's filter object too
            got = pe.search_embedded_batch(queries, filter_obj=f, **kw)
            _same_hits(want, got, key)
            for hits in got:
                assert all(_admits(FILTERS[case], h["id"], h["payload"]) for h in hits)
                if case == "nothing":
                    assert hits == []
    assert len(pe._mask_cache) == 1  # both filter objects have one signature: one mask


def test_filter_masks_are_memoised_per_manifest_version(built, queries):
    _, p = built
    pe = RetrievalEngine(p)
    f = build_filter(year=2022)
    m1 = pe._doc_mask(f)
    assert pe._doc_mask(build_filter(year=2022)) is m1  # same signature: same mask
    assert pe._doc_mask(None) is None and pe._doc_mask(PayloadFilter()) is None
    assert m1.tolist() == [pl["year"] == 2022 for pl in p.manifest.payloads]
    for i in range(70):
        pe._doc_mask(build_filter(extra={"n": i}))
    assert len(pe._mask_cache) == 64  # bounded
    # an append bumps the manifest version: the next search evaluates anew
    grown = RetrievalEngine(SealedIndex(stores=p.stores, manifest=copy.deepcopy(p.manifest)))
    before = grown._doc_mask(f)
    grown.index.manifest.add("late", {"year": 2022})
    after = grown._doc_mask(f)
    assert after is not before and after.tolist() == before.tolist() + [True]


@pytest.mark.parametrize("mode", SEARCH_MODES)
def test_search_embedded_matches_jax(built, queries, mode):
    je, pe = _pair(built, "auto")
    key = "score" if mode.startswith("single_") else "score_final"
    for q in queries[:2]:
        want = je.search_embedded(q, mode=mode, **CUTS)
        got = pe.search_embedded(q, mode=mode, **CUTS)
        _same_hits([want], [got], key)
        assert [h["payload"] for h in got] == [h["payload"] for h in want]
        assert set(got[0]) == set(want[0])


def test_policies(indexes):
    _, p = indexes
    pe = RetrievalEngine(p)
    assert not pe._use_packed(256)  # the CPU keeps the padded wire
    assert RetrievalEngine(p, query_wire="packed")._use_packed(1)
    ragged = pe._fused_arrays("initial")
    assert rerank_route(ragged, p.num_docs, 64, 10, True) == "scan"  # 640 >= 4 * 100
    assert rerank_route(ragged, p.num_docs, 32, 10, True) == "plain"
    assert rerank_route(ragged, p.num_docs, 256, 200, False) == "sweep"  # coverage 256*200*96/6400
    qs, n_real, b = RetrievalEngine._bucket_batch(list(range(33)))
    assert (n_real, b, len(qs)) == (33, 64, 64)
    assert RetrievalEngine._bucket_batch(list(range(300)))[2] == 512


def _arrays_equal(a, b):
    return all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("ids", "scores", "valid", "indices"))


@pytest.mark.parametrize("query_wire", ["padded", "packed"])
@pytest.mark.parametrize("mode", ["two_stage", "three_stage"])
def test_cpu_pipeline_takes_the_plain_path(built, queries, mode, query_wire):
    _, p = built
    pe = RetrievalEngine(p, query_wire=query_wire)
    kw = dict(mode=mode, with_payload=False, return_arrays=True, **CUTS)
    batches = [queries[i:i + 3] for i in range(0, 24, 3)]  # 8 distinct batches
    kept, piped = None, []
    for res in pe.search_embedded_batches(batches, depth=2, **kw):
        if not piped:  # batch 0 as it was yielded
            kept = {k: getattr(res, k).copy() for k in ("ids", "scores", "indices")}
        piped.append(res)
    assert pe.transfer_stats == {"batches": 8, "pinned": 0}
    for got, qb in zip(piped, batches):
        assert _arrays_equal(got, pe.search_embedded_batch(qb, **kw))
    assert all(np.array_equal(kept[k], getattr(piped[0], k)) for k in kept)
    assert pe.transfer_stats == {"batches": 16, "pinned": 0}


def test_transfer_stats_count_every_batch_across_threads(indexes, queries):
    _, p = indexes
    pe = RetrievalEngine(p)
    kw = dict(top_k=5, prefetch_k=20, with_payload=False)
    want = [pe.search_embedded(q, **kw) for q in queries[:4]]
    got, errors = {}, []

    def worker(t):
        try:
            for i in range(6):
                got[(t, i)] = pe.search_embedded(queries[(t + i) % 4], **kw)
        except Exception as ex:  # reported below
            errors.append(ex)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert pe.transfer_stats == {"batches": 4 + 48, "pinned": 0}
    assert all(hits == want[(t + i) % 4] for (t, i), hits in got.items()) and len(got) == 48


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
