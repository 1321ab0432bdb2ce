"""The port's K3 (dedup) and K4 (sweep) reranks and its rerank policy, on the
CPU, against the JAX package.

- The plain versions, which run each kernel's own bookkeeping
  (``dedup_layout``, ``sweep_layout``) and score the sorted pairs in f32,
  against ``rerank_candidates_dedup`` and ``rerank_candidates_sweep`` in
  interpret mode, on the cases of the JAX suite
  (``tests/test_pallas_kernels.py:170-321``): heavy sharing, uniform
  candidates, ``r_step`` 64 / 128 / 4096 (many ranges, multi-block ranges,
  one range), a mostly -1 grid, 0-token docs (the last one included),
  unaligned NQ, per-doc scales, int8 codes. f32 on both sides (int8: the
  same bf16-rounded queries and exact products on both sides), only the
  summation order differs: 1e-5, as ``tests/test_torch_port_kernels.py``
  and ``tests/test_torch_port_int8.py``.
- The layouts' invariants, which a GPU run cannot show on the CPU.
- The engine with ``rerank_impl="dedup"`` and ``"sweep"`` against the JAX
  engine (``stage1_cut="exact"``; on the CPU its XLA rerank computes the
  same function): ``two_stage`` with both stage-1 kinds on both wires,
  ``three_stage`` and filters, ids under ``strict_rank_equal`` and scores
  within 1e-5.
- The auto policy against the JAX engine's ``_rerank_impl`` over a grid of
  batch sizes, candidate counts and both wires on two indexes, equal except
  for the declared difference (ROADMAP): where the TPU's VMEM/SMEM budgets
  refuse the sweep and the coverage asks for it, the port runs K4 where
  JAX runs K3. Then the routes at the 100k and 3k serving geometries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_rag_tpu.index.synth import synthetic_index as jax_synthetic_index
from visual_rag_tpu.ops.kernels.maxsim_rerank import rerank_candidates_dedup as jax_dedup
from visual_rag_tpu.ops.kernels.maxsim_sweep import rerank_candidates_sweep as jax_sweep
from visual_rag_tpu.ops.kernels.maxsim_sweep import sweep_params as jax_sweep_params
from visual_rag_tpu.ops.kernels.maxsim_sweep import sweep_supported as jax_sweep_supported
from visual_rag_tpu.retrieval import RetrievalEngine as JaxEngine
from visual_rag_tpu.retrieval import build_filter as jax_build_filter
from visual_rag_tpu_torch.index.convert import sealed_from_numpy
from visual_rag_tpu_torch.ops.kernels import maxsim_rerank as mr
from visual_rag_tpu_torch.ops.kernels import maxsim_sweep as ms
from visual_rag_tpu_torch.ops.kernels._checks import ceil32
from visual_rag_tpu_torch.retrieval import local
from visual_rag_tpu_torch.retrieval.engine import RetrievalEngine
from visual_rag_tpu_torch.retrieval.filters import build_filter
from visual_rag_tpu_torch.retrieval.oracle import strict_rank_equal
from test_torch_port_engine import built, indexes, queries  # noqa: F401 (fixtures)

torch.set_num_threads(1)  # tier-1 runs several test workers at once

DIM = 128
TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF = -1e30


def _store(seed=0, n_docs=23, lo=3, hi=40, empty=(4, 22), int8=False):
    """A ragged store in the JAX layout (32-row-aligned docs, a tail pad of
    ceil32(max_len) rows) shaped as the JAX suite's ``small_index`` (23 docs
    of 3-40 tokens), with 0-token docs (the last one included) and per-doc
    scales. ``int8``: random codes in place of unit rows."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi, n_docs).astype(np.int32)
    lengths[list(empty)] = 0
    aligned = (lengths + 31) // 32 * 32
    offsets = np.concatenate([[0], np.cumsum(aligned[:-1])]).astype(np.int32)
    max_len = int(lengths.max())
    rows = int(aligned.sum()) + (max_len + 31) // 32 * 32
    if int8:
        flat = rng.integers(-127, 128, (rows, DIM)).astype(np.int8)
    else:
        flat = rng.standard_normal((rows, DIM)).astype(np.float32)
        flat /= np.linalg.norm(flat, axis=1, keepdims=True)
    scales = rng.uniform(0.002, 0.02 if int8 else 2.0, n_docs).astype(np.float32)
    return flat, offsets, lengths, max_len, scales


def _queries(seed, b, nq):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nq, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qmask = np.ones((b, nq), np.float32)
    qmask[1, nq // 2 + 1:] = 0.0  # a partial mask, as the JAX suite's qmask[1, 5:]
    return q, qmask


def _cands(case, seed, b, k, n_docs, empty):
    rng = np.random.default_rng(seed)
    if case == "heavy_sharing":  # every query draws from the same 6 docs
        c = rng.integers(0, 6, (b, k))
        c[0, -1] = c[3, 0] = -1
    elif case == "uniform":
        c = np.stack([rng.permutation(n_docs)[:k] for _ in range(b)])
    elif case == "mostly_invalid":
        c = np.full((b, k), -1)
        keep = rng.random((b, k)) < 0.15
        c[keep] = rng.integers(0, n_docs, int(keep.sum()))
    else:  # any docs, -1 slots, and the 0-token docs in every row
        c = rng.integers(-1, n_docs, (b, k))
        c[:, 0], c[:, 1] = empty
    return c.astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_args(flat, offs, lens, q, qmask, cand):
    return [jnp.asarray(a) for a in (flat, offs, lens, q, qmask, cand)]


# (case, b, k, nq, with_scales, int8): the JAX suite's cases and the 0-token one
DEDUP_CASES = {
    "heavy_sharing": ("heavy_sharing", 5, 12, 8, False, False),
    "uniform": ("uniform", 3, 8, 8, False, False),
    "empty_docs_scales": ("any", 4, 9, 16, True, False),
    "mostly_invalid": ("mostly_invalid", 8, 16, 8, False, False),
    "unaligned_nq": ("uniform", 3, 7, 20, False, False),
    "int8_scales": ("any", 4, 9, 16, True, True),
}


@pytest.mark.parametrize("name", sorted(DEDUP_CASES))
def test_dedup_plain_matches_pallas_interpret(name):
    case, b, k, nq, with_scales, int8 = DEDUP_CASES[name]
    flat, offs, lens, max_len, scales = _store(seed=1, int8=int8)
    q, qmask = _queries(2, b, nq)
    cand = _cands(case, 3, b, k, len(lens), (4, 22))
    sc = scales if with_scales else None
    want = np.asarray(jax_dedup(*_jax_args(flat, offs, lens, q, qmask, cand), max_len,
                                doc_scales=None if sc is None else jnp.asarray(sc),
                                group=4, n_slots=4, interpret=True))
    args = (*_t(flat, offs, lens, q, qmask, cand), max_len,
            None if sc is None else torch.from_numpy(sc))
    got = mr.rerank_candidates_dedup_ref(*args).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, mr.rerank_candidates_ref(*args).numpy(), **TOL)
    dead = (cand < 0) | (lens[np.maximum(cand, 0)] == 0)
    assert (got[dead] == NEG_INF).all() and (got[~dead] > NEG_INF / 2).all()


# (case, b, k, nq, r_step, with_scales, int8, jax kwargs)
SWEEP_CASES = {
    "r_step_64": ("any", 5, 12, 16, 64, False, False, {}),
    "r_step_128": ("any", 5, 12, 16, 128, False, False, {}),
    "r_step_4096_one_range": ("any", 5, 12, 16, 4096, False, False, {}),
    "multi_block_heavy_sharing": ("heavy_sharing", 16, 10, 8, 64, False, False,
                                  {"mgroups": 1}),
    "mostly_invalid": ("mostly_invalid", 8, 16, 8, 64, False, False, {}),
    "unaligned_nq": ("uniform", 3, 7, 20, 96, False, False, {}),
    "scales": ("any", 4, 9, 16, 96, True, False, {}),
    "int8_scales": ("any", 4, 9, 16, 96, True, True, {}),
}


@pytest.mark.parametrize("name", sorted(SWEEP_CASES))
def test_sweep_plain_matches_pallas_interpret(name):
    case, b, k, nq, r_step, with_scales, int8, jkw = SWEEP_CASES[name]
    flat, offs, lens, max_len, scales = _store(seed=4, int8=int8)
    q, qmask = _queries(5, b, nq)
    cand = _cands(case, 6, b, k, len(lens), (4, 22))
    sc = scales if with_scales else None
    want = np.asarray(jax_sweep(*_jax_args(flat, offs, lens, q, qmask, cand), max_len,
                                doc_scales=None if sc is None else jnp.asarray(sc),
                                r_step=r_step, interpret=True, **jkw))
    args = (*_t(flat, offs, lens, q, qmask, cand), max_len,
            None if sc is None else torch.from_numpy(sc))
    got = ms.rerank_candidates_sweep_ref(*args, r_step=r_step).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, mr.rerank_candidates_ref(*args).numpy(), **TOL)
    dead = (cand < 0) | (lens[np.maximum(cand, 0)] == 0)
    assert (got[dead] == NEG_INF).all() and (got[~dead] > NEG_INF / 2).all()


@pytest.mark.parametrize("rows,max_len,r_step", [
    (704, 40, 64), (704, 40, 4096), (20738560, 256, 512), (1776640, 832, 512), (96, 77, 64)])
def test_sweep_params_match_jax(rows, max_len, r_step):
    assert ms.sweep_params(rows, max_len, r_step) == jax_sweep_params(rows, max_len, r_step)


def _check_dedup_layout(run_pairs=None):
    rng = np.random.default_rng(7)
    b, k, n_docs = 24, 40, 50
    cand = rng.integers(0, 8, (b, k))  # heavy sharing: runs cut at run_pairs
    cand[rng.random((b, k)) < 0.2] = -1
    cand[0, :3] = [n_docs, n_docs + 7, 10**6]  # out of range: dead
    cand[1, :] = rng.integers(10, n_docs, k)
    lengths = torch.ones(n_docs, dtype=torch.int32)
    cand = torch.from_numpy(cand.astype(np.int32))
    if run_pairs is None:  # the default: RUN_PAIRS
        sorted_ids, order, starts = mr.dedup_layout(cand, lengths)
        run_pairs = mr.RUN_PAIRS
    else:
        sorted_ids, order, starts = mr.dedup_layout(cand, lengths, run_pairs)
    total = b * k
    s, o, st = sorted_ids.numpy(), order.numpy(), starts.numpy()
    flat = cand.numpy().reshape(-1)
    assert sorted(o.tolist()) == list(range(total))
    want_ids = np.where((flat >= 0) & (flat < n_docs), flat, -1)[o]
    assert (s == want_ids).all() and (np.diff(s) >= 0).all()
    n_runs = int((st < total).sum())
    assert len(st) == min(total, -(-total // run_pairs) + n_docs) + 1 >= n_runs + 1
    assert (st[n_runs:] == total).all() and (np.diff(st) >= 0).all()
    covered = np.zeros(total, bool)
    for r in range(n_runs):
        run = np.arange(st[r], st[r + 1])
        assert 1 <= len(run) <= run_pairs and len(set(s[run])) == 1 and s[run[0]] >= 0
        covered[run] = True
    assert (covered == (s >= 0)).all()
    live = s >= 0
    assert n_runs == sum(-(-int((s[live] == d).sum()) // run_pairs) for d in set(s[live]))


def test_dedup_layout_invariants():
    """Sorted ids ascend; runs hold 1..RUN_PAIRS pairs of one doc, start
    where a doc starts or every RUN_PAIRS pairs, and cover every live pair
    once; -1 and out-of-range ids are dead; ``starts`` ends in sentinels."""
    _check_dedup_layout()


@pytest.mark.parametrize("run_pairs", [12, 8, 2, 1])
def test_dedup_layout_invariants_at_shorter_runs(run_pairs):
    """The same invariants with runs cut at the sizes K3's tensor-core body
    asks for (``dedup_run_pairs``): 12 pairs of 32-row queries, 8 of 33-48,
    2 of 130, 1 of 320."""
    _check_dedup_layout(run_pairs)


@pytest.mark.parametrize("dtype,dim,nq,want", [
    (torch.bfloat16, 128, 3, 16), (torch.bfloat16, 128, 16, 16), (torch.bfloat16, 128, 32, 12),
    (torch.float16, 128, 33, 8), (torch.int8, 128, 130, 2), (torch.int8, 128, 352, 1),
    (torch.bfloat16, 64, 32, 16), (torch.float32, 128, 32, 16)])
def test_dedup_run_pairs_fit_the_tensor_core_body(dtype, dim, nq, want):
    """Runs of K3's tensor-core body (bf16, f16 and int8 codes at dim 128)
    hold at most ``MMA_QTILES`` query tiles of 16 rows and 16 pairs; the
    CUDA-core body (f32, other widths) keeps ``RUN_PAIRS``."""
    assert mr.dedup_run_pairs(dtype, dim, nq) == want
    assert mr.uses_mma(dtype, dim) == (dim == 128 and dtype != torch.float32)
    if mr.uses_mma(dtype, dim):
        assert want * -(-nq // 16) <= mr.MMA_QTILES


@pytest.mark.parametrize("r_step", [64, 96, 4096])
def test_sweep_layout_invariants(r_step):
    """Ranges ascend and hold exactly the pairs whose doc starts in them,
    in query order; each live window lies in its range's ``r_rows``-row
    window and starts at its doc's first row; -1, out-of-range and 0-token
    pairs are dead, past ``pair_start[n_ranges]``."""
    flat, offs, lens, max_len, scales = _store(seed=8)
    rng = np.random.default_rng(9)
    b, k = 6, 15
    cand = rng.integers(-1, len(lens), (b, k))
    cand[2, :2] = [len(lens), 4]  # out of range; a 0-token doc
    step, r_rows, n_ranges = ms.sweep_params(flat.shape[0], max_len, r_step)
    lay = ms.sweep_layout(*_t(cand.astype(np.int32), offs, lens), flat.shape[0], max_len,
                          torch.from_numpy(scales), r_step)
    lay = {key: v.numpy() if isinstance(v, torch.Tensor) else v for key, v in lay.items()}
    assert lay["n_ranges"] == n_ranges
    ps, o = lay["pair_start"], lay["order"]
    assert len(ps) == n_ranges + 1 and ps[0] == 0 and (np.diff(ps) >= 0).all()
    fc = cand.reshape(-1)
    live_flat = (fc >= 0) & (fc < len(lens)) & (lens[np.clip(fc, 0, len(lens) - 1)] > 0)
    assert ps[-1] == live_flat.sum() and not live_flat[o[ps[-1]:]].any()
    for r in range(n_ranges):
        seg = np.arange(ps[r], ps[r + 1])
        docs = fc[o[seg]]
        assert (offs[docs] // step == r).all()
        assert (lay["pair_q"][seg] == o[seg] // k).all() and (np.diff(lay["pair_q"][seg]) >= 0).all()
        start = lay["range_start"][r]
        assert start == min(r * step, flat.shape[0] - r_rows)
        assert (start + lay["pair_off"][seg] == offs[docs]).all()
        assert (lay["pair_off"][seg] >= 0).all()
        assert (lay["pair_off"][seg] + lay["pair_len"][seg] <= r_rows).all()
        np.testing.assert_array_equal(lay["pair_scale"][seg], scales[docs])


def test_wrappers_run_the_plain_versions_on_cpu():
    """On CPU tensors the wrappers are their plain versions (no launch
    counted); other devices are refused."""
    flat, offs, lens, max_len, scales = _store(seed=10)
    q, qmask = _queries(11, 4, 8)
    cand = _cands("any", 12, 4, 9, len(lens), (4, 22))
    args = (*_t(flat, offs, lens, q, qmask, cand), max_len, torch.from_numpy(scales))
    for fn, ref in ((mr.rerank_candidates_dedup, mr.rerank_candidates_dedup_ref),
                    (ms.rerank_candidates_sweep, ms.rerank_candidates_sweep_ref)):
        before = fn.launches
        torch.testing.assert_close(fn(*args), ref(*args), rtol=0, atol=0)
        assert fn.launches == before
        meta = torch.empty(flat.shape, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            fn(meta, *args[1:])


def test_local_rerank_routes(monkeypatch):
    """``dedup`` at B == 1 runs K2 (``sharded.py:477``); ``sweep`` outside
    the sweep kernel's envelope runs ``dedup`` (``:476``); ``dedup`` outside
    its own runs K2. ``rerank_route`` asks the envelope at the 32-token
    hint, ``local_rerank`` at the real query's length (8 tokens here)."""
    flat, offs, lens, max_len, _ = _store(seed=13)
    ragged = dict(zip(("flat", "offsets", "lengths"), _t(flat, offs, lens)), max_len=max_len)
    calls = []
    for name in ("rerank_candidates", "rerank_candidates_dedup", "rerank_candidates_sweep"):
        monkeypatch.setattr(local, name, lambda *a, _n=name, **kw: calls.append(_n))

    def route(b, impl):
        q, qmask = _queries(14, max(b, 2), 8)
        cand = _cands("any", 15, b, 5, len(lens), (4, 22))
        calls.clear()
        local.local_rerank(ragged, *_t(q[:b], qmask[:b], cand), impl, None, b)
        return calls[0]

    assert route(1, "dedup") == "rerank_candidates"
    assert route(4, "dedup") == "rerank_candidates_dedup"
    assert route(4, "sweep") == "rerank_candidates_sweep"
    assert route(4, "plain") == "rerank_candidates"
    monkeypatch.setattr(local, "sweep_supported", lambda rows, ml, b, k, nq, *a: nq > 8)
    assert local.rerank_route(ragged, len(lens), 64, 5, False) == "sweep"
    assert route(4, "sweep") == "rerank_candidates_dedup"
    monkeypatch.setattr(local, "sweep_supported", lambda *a: False)
    assert route(4, "sweep") == "rerank_candidates_dedup"
    monkeypatch.setattr(local, "pair_kernels_fit", lambda *a: False)
    assert route(4, "sweep") == "rerank_candidates"
    with pytest.raises(ValueError, match="rerank impl"):
        route(4, "nope")


def _same(jax_hits, port_hits, key="score_final", cols=()):
    assert len(jax_hits) == len(port_hits)
    for jh, ph in zip(jax_hits, port_hits):
        assert strict_rank_equal([dict(h, score=h[key]) for h in jh], ph, score_tol=1e-5)
        by_id = {h["id"]: h for h in ph}
        for h in jh:
            for col in cols:
                assert abs(h[col] - by_id[h["id"]][col]) <= 1e-5, (col, h)


@pytest.mark.parametrize("query_wire", ["padded", "packed"])
@pytest.mark.parametrize("stage1_mode", ["pooled_query_vs_standard_pooling",
                                         "tokens_vs_standard_pooling"])
@pytest.mark.parametrize("impl", ["dedup", "sweep"])
def test_two_stage_matches_jax(indexes, queries, impl, stage1_mode, query_wire):  # noqa: F811
    j, p = indexes
    je = JaxEngine(j, stage1_cut="exact", query_wire=query_wire, rerank_impl=impl)
    pe = RetrievalEngine(p, query_wire=query_wire, rerank_impl=impl)
    for pk in (30, 200):  # 200 clamps to the corpus
        kw = dict(mode="two_stage", top_k=10, prefetch_k=pk, stage1_mode=stage1_mode,
                  with_payload=False)
        _same(je.search_embedded_batch(queries, **kw), pe.search_embedded_batch(queries, **kw))


@pytest.mark.parametrize("run", ["three_stage", "two_stage_filtered", "three_stage_filtered"])
@pytest.mark.parametrize("impl", ["dedup", "sweep"])
def test_three_stage_and_filters_match_jax(built, queries, impl, run):  # noqa: F811
    j, p = built
    je = JaxEngine(j, stage1_cut="exact", rerank_impl=impl)
    pe = RetrievalEngine(p, rerank_impl=impl)
    kw = dict(mode=run.split("_filtered")[0], top_k=5, prefetch_k=12, stage1_k=20,
              stage2_k=12)
    cols = ("score_stage1", "score_stage2") if kw["mode"] == "three_stage" else ()
    jf = pf = None
    if run.endswith("filtered"):
        jf, pf = jax_build_filter(year=[2020, 2023]), build_filter(year=[2020, 2023])
    got = pe.search_embedded_batch(queries, filter_obj=pf, **kw)
    _same(je.search_embedded_batch(queries, filter_obj=jf, **kw), got, cols=cols)
    if pf is not None:
        assert all(h["payload"]["year"] in (2020, 2023) for hits in got for h in hits)


def _route(engine, b, k, packed):
    """The rerank ``engine`` asks for at a bucketed batch ``b``, as its
    ``_dispatch_batch`` asks ``local.rerank_route``."""
    return local.rerank_route(engine._fused_arrays(engine.full_vector_name),
                              engine.index.num_docs, b, k, packed, engine.rerank_impl)


@pytest.mark.parametrize("pk,route", [(5, "dedup"), (30, "sweep")])
def test_auto_routes_a_batch_of_64_as_jax_and_matches_it(indexes, queries, pk, route):  # noqa: F811
    """64 queries on the padded wire over the 100-doc index: coverage 4.8
    at prefetch 5 (``dedup``), 29 at prefetch 30 (``sweep``), the JAX
    policy's choice too; the answers match the JAX engine's."""
    j, p = indexes
    pe = RetrievalEngine(p, query_wire="padded")
    je = JaxEngine(j, stage1_cut="exact", query_wire="padded")
    assert _route(pe, 64, pk, False) == route == je._rerank_impl(64, pk)
    qs = (queries * 3)[:64]
    kw = dict(mode="two_stage", top_k=5, prefetch_k=pk, with_payload=False)
    _same(je.search_embedded_batch(qs, **kw), pe.search_embedded_batch(qs, **kw))


@pytest.fixture(scope="module")
def wide():
    """1500 docs of 16-48 tokens (JAX synthetic, f32), carried across: a
    geometry where B*K < 4*D and coverage < 6 both occur (dedup)."""
    j = jax_synthetic_index(1500, min_tokens=16, max_tokens=48, pooled_rows=2,
                            storage_dtype="float32", seed=9)
    st = j.store("initial")
    stores = {"initial": {k: np.asarray(getattr(st, k)) for k in ("flat", "offsets", "lengths")}
              | {"max_len": st.max_len}}
    return j, sealed_from_numpy(stores, j.manifest.ids, j.manifest.payloads, "float32", "cpu")


def _geom(ragged):
    """(rows, max_len, query tokens, dim, itemsize) of a token store as the
    JAX engine's ``_ragged_geom`` gives them: its 32-token query hint."""
    flat = ragged["flat"]
    return (int(flat.shape[0]), int(ragged["max_len"]), 32, int(flat.shape[1]),
            flat.element_size())


def _jax_policy(je, b, k, packed, n_docs):
    return je._rerank_impl(b, k, **({"n_docs": n_docs, "m_packed": 32 * b} if packed else {}))


def _declared(geom, b, k, port, jax):
    """The declared difference: JAX's TPU budgets refuse the sweep that
    the coverage asks for, so JAX runs K3 where the port runs K4."""
    rows, max_len, nq, dim, itemsize = geom
    cov = b * k * ceil32(max_len) / rows
    return (port, jax) == ("sweep", "dedup") and cov >= 6 and not jax_sweep_supported(
        rows, max_len, min(b, 256), k, nq, dim, itemsize, r_step=512, n_bufs=2)


@pytest.mark.parametrize("b", [1, 32, 64, 256, 1024])
@pytest.mark.parametrize("which", ["indexes", "wide"])
def test_policy_grid_matches_jax(request, which, b):
    """The port's ``rerank_route`` equals the JAX engine's ``_rerank_impl``
    on the same index for K in {10, 200, 1000} on both wires, but for the
    declared difference. Below ``DEDUP_MIN_BATCH`` both say ``plain``,
    whatever the scan ratio."""
    j, p = request.getfixturevalue(which)
    je, pe = JaxEngine(j), RetrievalEngine(p)
    geom = _geom(pe._fused_arrays("initial"))
    assert je._ragged_geom() == geom
    seen, declared = set(), []
    for k in (10, 200, 1000):
        for packed in (False, True):
            port = _route(pe, b, k, packed)
            jax = _jax_policy(je, b, k, packed, p.num_docs)
            if port != jax:
                assert _declared(geom, b, k, port, jax), (k, packed, port, jax)
                declared.append((k, packed))
            seen.add(port)
    if b < 64:
        assert seen == {"plain"}
    # JAX's SMEM budget refuses 256 x 1000 pairs on the padded wire
    assert declared == ([(1000, False)] if b >= 256 else [])


# chip_smoke.py's corpora: 100k docs of 128-256 tokens, 3k docs of 320-832 (bf16)
GEOM_100K = ((20738560, 256, 32, 128, 2), 100000)
GEOM_3K = ((1776640, 832, 32, 128, 2), 3000)


@pytest.mark.parametrize("geom,n_docs,b,k,packed,route", [
    (*GEOM_100K, 1024, 200, True, "dedup"),  # two_stage, coverage ~2.5
    (*GEOM_100K, 1024, 300, True, "dedup"),  # three_stage on stage2_k
    (*GEOM_100K, 32, 200, True, "plain"),
    (*GEOM_3K, 256, 200, False, "sweep"),  # padded wire, coverage ~24
    (*GEOM_3K, 256, 200, True, "scan"),  # packed: B*K >= 4*D
    (*GEOM_3K, 32, 200, True, "plain"),
])
def test_routes_at_the_serving_geometries(indexes, geom, n_docs, b, k, packed, route):  # noqa: F811
    """The auto route at chip_smoke.py's 100k and 3k geometries, the port's
    over a store of that geometry on the meta device and the JAX engine's
    with its store geometry replaced (the policy only: no large index on
    the CPU)."""
    j, _ = indexes
    rows, max_len, _, dim, _ = geom
    ragged = {"flat": torch.empty((rows, dim), dtype=torch.bfloat16, device="meta"),
              "max_len": max_len}
    assert _geom(ragged) == geom
    assert local.rerank_route(ragged, n_docs, b, k, packed) == route
    je = JaxEngine(j)
    je._ragged_geom = lambda: geom
    assert _jax_policy(je, b, k, packed, n_docs) == route


def test_explicit_impls_pass_through(indexes):  # noqa: F811
    _, p = indexes
    for impl in ("plain", "dedup", "sweep"):
        assert _route(RetrievalEngine(p, rerank_impl=impl), 1024, 200, True) == impl
    with pytest.raises(ValueError, match="auto\\|plain\\|dedup\\|sweep\\|scan"):
        RetrievalEngine(p, rerank_impl="nope")
