"""int8 and int8_refined storage in the port, on the CPU, vs the JAX package.

- Quantization: ``index/quantize.py`` against the JAX seal (``IndexBuilder``
  with an int8 schema) and against the JAX numpy fallbacks on the same f32
  input; ``sealed_from_numpy`` of a JAX int8 index keeps every byte.
- The plain versions of the kernels' int8 bodies (bf16 queries) and qdot
  bodies (int8 queries, integer dots) against the Pallas kernels in
  interpret mode and the XLA fallbacks: K1 (scan), K2 (rerank), K5/K6/K7
  (tokens stage-1, P = 10 with mask holes and a doc with no valid row), and
  the int4-residual refine against ``xla_refine_rerank``. Both sides round
  the same way, so scores agree to 1e-5 (f32 sums in another order).
- The traps of an int8 store that the port's float-only code had: queries
  cast to the store dtype (int8 codes) instead of bf16, scales dropped by
  the pooled stage-1, the rerank and the scan, the single-vector store.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_rag_tpu import native
from visual_rag_tpu.index import CollectionSchema, IndexBuilder
from visual_rag_tpu.index import store as jax_store
from visual_rag_tpu.ops import (
    colsmol_experimental_pooling,
    global_mean_pooling,
    tile_level_mean_pooling,
)
from visual_rag_tpu.ops.kernels import prefetch_topk as jax_pt
from visual_rag_tpu.ops.kernels.maxsim_rerank import rerank_candidates as jax_rerank
from visual_rag_tpu.ops.kernels.maxsim_scan import exhaustive_scores_packed as jax_scan
from visual_rag_tpu.ops.kernels.maxsim_scan import quantize_queries_int8 as jax_quantize_q
from visual_rag_tpu.parallel import sharded as S
from visual_rag_tpu.retrieval import batch as B
from visual_rag_tpu_torch.index.convert import sealed_from_numpy
from visual_rag_tpu_torch.index.quantize import (
    doc_scale_rows,
    quantize_index,
    quantize_per_doc,
    quantize_rows_int8,
    residual_int4,
)
from visual_rag_tpu_torch.index.store import RaggedMultiVectors, SingleVectors
from visual_rag_tpu_torch.ops.kernels import prefetch_topk as pt
from visual_rag_tpu_torch.ops.kernels.maxsim_rerank import rerank_candidates
from visual_rag_tpu_torch.ops.kernels.maxsim_scan import (
    exhaustive_scores_packed,
    quantize_queries_int8,
)
from visual_rag_tpu_torch.ops.kernels.refine import refine_rerank, refine_window
from visual_rag_tpu_torch.retrieval import local, wire
from visual_rag_tpu_torch.retrieval.engine import RetrievalEngine

torch.set_num_threads(1)  # tier-1 runs several test workers at once

DIM = 128
TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF = -1e30


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def numpy_stores(index):
    """The arrays of a JAX SealedIndex's stores, as ``sealed_from_numpy`` takes them."""
    out = {}
    for name in index.vector_names:
        st = index.store(name)
        if hasattr(st, "flat"):
            arrs = {k: np.asarray(getattr(st, k)) for k in ("flat", "offsets", "lengths")}
            arrs["max_len"] = st.max_len
            keys = ("scales", "res4", "res_scales")
        else:
            arrs = {"values": np.asarray(st.values)}
            if hasattr(st, "mask"):
                arrs["mask"] = np.asarray(st.mask)
            keys = ("scales",)
        for k in keys:
            if getattr(st, k) is not None:
                arrs[k] = np.asarray(getattr(st, k))
        out[name] = arrs
    return out


def build_jax(storage_dtype, n_docs=30, seed=11):
    """A JAX IndexBuilder index of all four stores, the pooled stores padded
    with invalid rows, ``year``/``source`` payloads (as the verify recipe)."""
    rng = np.random.default_rng(seed)
    b = IndexBuilder(CollectionSchema.standard(storage_dtype=storage_dtype))
    for i in range(n_docs):
        tiles = int(rng.integers(2, 6))
        t = rng.standard_normal((tiles * 64 + int(rng.integers(0, 20)), DIM)).astype(np.float32)
        mp = np.asarray(tile_level_mean_pooling(t, tiles))
        b.add(f"p{i}", {"initial": t, "mean_pooling": mp,
                        "experimental_pooling": np.asarray(colsmol_experimental_pooling(t, tiles)),
                        "global_pooling": np.asarray(global_mean_pooling(mp))},
              {"year": 2020 + i % 4, "source": "ab"[i % 2]})
    return b.seal()


def carried(jidx, storage_dtype):
    return sealed_from_numpy(numpy_stores(jidx), jidx.manifest.ids, jidx.manifest.payloads,
                             storage_dtype, "cpu")


@pytest.fixture(scope="module")
def seals():
    """JAX seals of one corpus in f32, int8 and int8_refined."""
    return {dt: build_jax(dt) for dt in ("float32", "int8", "int8_refined")}


# -- quantization ------------------------------------------------------------------


@pytest.mark.parametrize("storage_dtype", ["int8", "int8_refined"])
def test_quantize_index_matches_the_jax_seal(seals, storage_dtype):
    """quantize_index of the f32 seal against the JAX int8 seal of the same
    points: codes and res4 bytes equal, scales within 1 ulp. The JAX seal
    rounds with its native library where it loads (``x * (1 / s)``), the
    port as its numpy fallback does (``x / s``); on this corpus they agree."""
    q = quantize_index(carried(seals["float32"], "float32"), storage_dtype)
    want = numpy_stores(seals[storage_dtype])
    assert q.storage_dtype == storage_dtype
    for name, arrs in want.items():
        st = q.store(name)
        codes = (st.flat if isinstance(st, RaggedMultiVectors) else st.values).numpy()
        ref = arrs["flat"] if "flat" in arrs else arrs["values"]
        assert codes.dtype == np.int8 and codes.shape == ref.shape
        np.testing.assert_array_equal(codes, ref, err_msg=name)
        np.testing.assert_array_max_ulp(st.scales.numpy(), arrs["scales"], maxulp=1)
        if "res4" in arrs:
            np.testing.assert_array_equal(st.res4.numpy(), arrs["res4"])
            np.testing.assert_array_max_ulp(st.res_scales.numpy(), arrs["res_scales"], maxulp=1)
        else:
            assert getattr(st, "res4", None) is None
    assert q.store("initial").storage_dtype == storage_dtype


def _ragged_f32(seed=0, n_docs=20):
    """Normalised f32 rows in the JAX ragged layout with two empty docs."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 70, n_docs).astype(np.int32)
    lengths[[3, n_docs - 1]] = 0
    aligned = (lengths + 31) // 32 * 32
    offsets = np.concatenate([[0], np.cumsum(aligned[:-1])]).astype(np.int64)
    max_len = int(lengths.max())
    flat = np.zeros((int(aligned.sum()) + (max_len + 31) // 32 * 32, DIM), np.float32)
    for o, n in zip(offsets, lengths):
        x = rng.standard_normal((n, DIM)).astype(np.float32) * rng.uniform(0.2, 3.0)
        flat[o:o + n] = x / np.linalg.norm(x, axis=1, keepdims=True)
    return flat, offsets, lengths, max_len


def test_quantizers_equal_the_numpy_fallback(monkeypatch):
    """On the same f32 input the port's quantizers equal the JAX package's
    numpy fallbacks bit for bit: per-row codes and scales (a zero row
    included), per-doc codes and scales (empty docs included), the int4
    residual bytes and scales (zero bytes off the docs)."""
    flat, offs, lens, _ = _ragged_f32()
    rows = flat[:300].copy()
    rows[5] = 0.0
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.native_available()
    c_np, s_np = native.quantize_int8(rows)
    c_pt, s_pt = quantize_rows_int8(_t(rows))
    np.testing.assert_array_equal(c_pt.numpy(), c_np)
    np.testing.assert_array_equal(s_pt.numpy(), s_np)
    codes_np, ds_np = native.quantize_per_doc(flat, offs, lens)
    codes_pt, ds_pt = quantize_per_doc(_t(flat), _t(offs.astype(np.int32)), _t(lens))
    np.testing.assert_array_equal(codes_pt.numpy(), codes_np)
    np.testing.assert_array_equal(ds_pt.numpy(), ds_np)
    r4_np, rs_np = jax_store._residual_int4(flat, codes_np, ds_np, offs, lens)
    r4_pt, rs_pt = residual_int4(_t(flat), codes_pt, ds_pt, _t(offs.astype(np.int32)), _t(lens))
    np.testing.assert_array_equal(r4_pt.numpy(), r4_np)
    np.testing.assert_array_equal(rs_pt.numpy(), rs_np)
    np.testing.assert_array_equal(
        doc_scale_rows(_t(offs), _t(lens), ds_pt, flat.shape[0]).numpy(),
        jax_store.doc_scale_rows(offs, lens, ds_np, flat.shape[0]))


def test_native_rounding_against_the_port():
    """Where the JAX native library loads, its per-doc codes (``x * (1/s)``)
    may differ from the port's and its fallback's (``x / s``) by one code on
    a rare value. Count them on a larger input: at most 1e-4 of the codes,
    each by one, and the scales bit-equal."""
    if not native.native_available():
        pytest.skip("the JAX native library does not load here: nothing to compare")
    flat, offs, lens, _ = _ragged_f32(seed=1, n_docs=200)
    codes_nat, ds_nat = native.quantize_per_doc(flat, offs, lens)
    codes_pt, ds_pt = quantize_per_doc(_t(flat), _t(offs.astype(np.int32)), _t(lens))
    diff = codes_pt.numpy().astype(np.int16) - codes_nat
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= 1e-4 * diff.size, np.count_nonzero(diff)
    np.testing.assert_array_max_ulp(ds_pt.numpy(), ds_nat, maxulp=1)


@pytest.mark.parametrize("storage_dtype", ["int8", "int8_refined"])
def test_sealed_from_numpy_int8_keeps_bytes(seals, storage_dtype):
    jidx = seals[storage_dtype]
    p = carried(jidx, storage_dtype)
    want = numpy_stores(jidx)
    for name, arrs in want.items():
        st = p.store(name)
        for key, a in arrs.items():
            if key == "max_len":
                assert st.max_len == a
                continue
            t = getattr(st, "flat" if key == "flat" else key)
            assert t.numpy().tobytes() == np.asarray(a).tobytes(), (name, key)
        assert st.nbytes() == jidx.store(name).nbytes(), name
        assert st.storage_dtype == jidx.store(name).storage_dtype
    assert p.nbytes() == jidx.nbytes()
    jr, pr = jidx.store("initial"), p.store("initial")
    for refined in (False, True):
        np.testing.assert_allclose(pr.dequantized_flat(refined=refined).numpy(),
                                   jr.dequantized_flat(refined=refined), rtol=0, atol=1e-7)
    for name in ("mean_pooling", "global_pooling"):
        np.testing.assert_allclose(p.store(name).dequantized().numpy(),
                                   np.asarray(jidx.store(name).dequantized(jnp.float32)),
                                   rtol=0, atol=1e-7)


def test_refined_store_is_smaller_than_bf16(seals):
    """int8_refined holds ~1.53x int8's bytes and < 0.85x bf16's (JAX
    ``test_int8_refined.py:75-81``), counted on the port's stores."""
    f = carried(seals["float32"], "float32")
    r, p = (quantize_index(f, dt).store("initial") for dt in ("int8_refined", "int8"))
    bf16 = f.store("initial").flat.numel() * 2 + f.store("initial").offsets.numel() * 8
    assert r.nbytes() < 1.6 * p.nbytes() and r.nbytes() < 0.85 * bf16


# -- the kernels' plain versions -----------------------------------------------------


def _int8_store(seed=0, n_docs=30):
    """(codes, offsets, lengths, max_len, per-doc scales) of an int8 ragged
    store: three empty docs (the last included) and a max_len of 77."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 70, n_docs).astype(np.int32)
    lengths[[2, 9, n_docs - 1]] = 0
    lengths[4] = 77
    aligned = (lengths + 31) // 32 * 32
    offsets = np.concatenate([[0], np.cumsum(aligned[:-1])]).astype(np.int32)
    max_len = int(lengths.max())
    rows = int(aligned.sum()) + (max_len + 31) // 32 * 32
    x = rng.standard_normal((rows, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    codes, scales = quantize_per_doc(_t(x), _t(offsets), _t(lengths))
    return codes.numpy(), offsets, lengths, max_len, scales.numpy()


def _packed_queries(seed, b):
    rng = np.random.default_rng(seed)
    qs = [rng.standard_normal((int(rng.integers(3, 30)), DIM)).astype(np.float32)
          for _ in range(b)]
    (packed, _, qid), _, _ = wire.pack_queries_grouped(qs, DIM)
    packed = packed / (np.linalg.norm(packed, axis=1, keepdims=True) + 1e-8)
    return packed.astype(np.float32), qid


def _padded_queries(seed, b, nq):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nq, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qmask = np.ones((b, nq), np.float32)
    qmask[0, nq // 2:] = 0.0
    qmask[1, -1] = 0.0
    return q, qmask


def test_quantize_queries_matches_jax():
    q, _ = _packed_queries(1, 16)
    q[3] = 0.0  # a pad row: codes 0, scale 1e-12
    q[7, :5] = [0.5, -0.5, 1.5 / 127, 2.5 / 127, -0.5 / 127]  # halves round to even
    codes, scales = quantize_queries_int8(_t(q))
    jc, js = jax_quantize_q(jnp.asarray(q))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))


@pytest.mark.parametrize("qdot", [False, True])
@pytest.mark.parametrize("b", [8, 64])
def test_scan_int8_matches_pallas_and_xla(qdot, b):
    """K1 over int8 codes with per-doc scales: bf16 queries, or int8 queries
    and integer dots (qdot)."""
    codes, offs, lens, max_len, scales = _int8_store(seed=6)
    packed, qid = _packed_queries(7, b)
    want = np.asarray(jax_scan(
        jnp.asarray(codes), jnp.asarray(offs), jnp.asarray(lens), jnp.asarray(packed),
        jnp.asarray(qid), max_len, b=b, doc_scales=jnp.asarray(scales), interpret=True,
        qdot_int8=qdot))
    g, rg = qid.shape
    seg = (qid[:, None, :] == np.arange(b // g)[None, :, None]).astype(np.float32)
    xla = np.asarray(B.xla_exhaustive_packed(
        jnp.asarray(codes), jnp.asarray(offs), jnp.asarray(lens), jnp.asarray(packed),
        jnp.asarray(seg), max_len, scales=jnp.asarray(scales), chunk=4, qdot_int8=qdot))
    got = exhaustive_scores_packed(*map(_t, (codes, offs, lens, packed, qid)), max_len, b,
                                   _t(scales), qdot_int8=qdot).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)
    assert (got[:, lens == 0] == NEG_INF).all()
    with pytest.raises(ValueError, match="int8 store"):
        exhaustive_scores_packed(_t(codes.astype(np.float32)), _t(offs), _t(lens), _t(packed),
                                 _t(qid), max_len, b, qdot_int8=True)


def test_rerank_int8_matches_pallas_interpret():
    """K2 over int8 codes: queries rounded to bf16 (not cast to int8 codes),
    per-doc scale on the finished score."""
    codes, offs, lens, max_len, scales = _int8_store()
    q, qmask = _padded_queries(1, 3, 16)
    cand = np.random.default_rng(2).integers(-1, 30, (3, 21)).astype(np.int32)
    cand[:, 0] = 9  # an empty doc in every row
    want = np.asarray(jax_rerank(
        jnp.asarray(codes), jnp.asarray(offs), jnp.asarray(lens), jnp.asarray(q),
        jnp.asarray(qmask), jnp.asarray(cand), max_len, doc_scales=jnp.asarray(scales),
        interpret=True))
    got = rerank_candidates(*map(_t, (codes, offs, lens, q, qmask, cand)), max_len,
                            _t(scales)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[cand < 0] == NEG_INF).all() and (got[:, 0] == NEG_INF).all()


N_POOLED = 150
EMPTY = (7, N_POOLED - 1)  # docs with no valid pooled row


def _pooled_int8(p=10, seed=0):
    """P-leading int8 pooled store [P, D, dim] with per-row scales [P, D], a
    mask with holes and two docs with no valid row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((p, N_POOLED, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    codes, scales = quantize_rows_int8(_t(x))
    mask = rng.random((p, N_POOLED)) > 0.3
    mask[0, :] = True
    mask[:, list(EMPTY)] = False
    return codes.numpy(), mask, scales.numpy()


@pytest.mark.parametrize("qdot", [False, True])
def test_pooled_packed_int8_matches_pallas_and_xla(qdot):
    """K5 over int8 codes (bf16 queries), and its qdot body: K9's function."""
    vals, mask, scales = _pooled_int8()
    rng = np.random.default_rng(1)
    qs = [rng.standard_normal((int(rng.integers(3, 21)), DIM)).astype(np.float32)
          for _ in range(16)]
    (q, _, qid), _, _ = wire.pack_queries_grouped(qs, DIM, group=8)
    q = (q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-8)).astype(np.float32)
    seg = (qid[:, None, :] == np.arange(8)[None, :, None]).astype(np.float32)
    got = pt.pooled_maxsim_scores_packed(_t(vals), _t(mask), _t(q), _t(qid), 16,
                                         scales_t=_t(scales), qdot_int8=qdot).numpy()
    kernel = np.asarray(jax_pt.pooled_maxsim_scores_packed(
        jnp.asarray(vals), jnp.asarray(mask), jnp.asarray(q), jnp.asarray(seg),
        jnp.asarray(scales), interpret=True, qdot_int8=qdot))
    s1 = {"vals_t": jnp.asarray(vals), "mask_t": jnp.asarray(mask),
          "scales_t": jnp.asarray(scales)}
    fallback = np.asarray(S._local_tokens_padded_packed(s1, jnp.asarray(q), jnp.asarray(seg),
                                                        use_pallas=False, qdot=qdot))
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, fallback, **TOL)
    assert (got[:, list(EMPTY)] == 0.0).all()


@pytest.mark.parametrize("qdot", [False, True])
def test_pooled_padded_int8_matches_pallas(qdot):
    """K6 over int8 codes and its qdot body; K7 (no qdot form in JAX) over
    int8 codes, and its qdot entry point equals K6's."""
    vals, mask, scales = _pooled_int8(seed=3)
    q, qmask = _padded_queries(2, 8, 16)
    args = (_t(vals), _t(mask), _t(q), _t(qmask), _t(scales))
    got = pt.pooled_maxsim_scores_qbatch(*args, qdot_int8=qdot).numpy()
    kernel = np.asarray(jax_pt.pooled_maxsim_scores_qbatch(
        jnp.asarray(vals), jnp.asarray(mask), jnp.asarray(q), jnp.asarray(qmask),
        jnp.asarray(scales), interpret=True, qdot_int8=qdot))
    np.testing.assert_allclose(got, kernel, **TOL)
    one = pt.pooled_maxsim_scores(*args, qdot_int8=qdot).numpy()
    np.testing.assert_array_equal(one, got)
    if not qdot:
        k7 = np.asarray(jax_pt.pooled_maxsim_scores(
            jnp.asarray(vals), jnp.asarray(mask), jnp.asarray(q), jnp.asarray(qmask),
            jnp.asarray(scales), interpret=True))
        np.testing.assert_allclose(one, k7, **TOL)


def test_qdot_per_row_maxima_are_exact():
    """Integer dots are exact in f32 (|dot| <= 127 * 127 * 128 < 2**24), so
    with one row a group the qdot scores are ``qs * rowmax`` with rowmax an
    integer times the row's store scale, equal to an exact int64 product."""
    vals, mask, scales = _pooled_int8(p=4, seed=5)
    q, _ = _packed_queries(8, 8)
    m = q.shape[0]
    qid = np.zeros((m, 1), np.int32)
    got = pt.pooled_maxsim_scores_packed(_t(vals), _t(mask), _t(q), _t(qid), m,
                                         scales_t=_t(scales), qdot_int8=True).numpy()
    codes, qs = quantize_queries_int8(_t(q))
    dots = np.einsum("md,pnd->mpn", codes.numpy().astype(np.int64), vals.astype(np.int64))
    sims = np.where(mask[None], dots.astype(np.float32) * scales[None], NEG_INF).max(axis=1)
    sims = np.where(mask.any(axis=0)[None], sims, 0.0).astype(np.float32)
    np.testing.assert_array_equal(got, qs.numpy()[:, None] * sims)


def test_refine_matches_xla_refine_rerank(seals):
    """The refine pass (f32 queries against int8 + int4 rows) against
    ``xla_refine_rerank`` at 1e-5; -1 candidates score NEG_INF."""
    jr = seals["int8_refined"].store("initial")
    pr = carried(seals["int8_refined"], "int8_refined").store("initial")
    q, qmask = _padded_queries(4, 5, 24)
    cand = np.random.default_rng(6).integers(-1, 30, (5, 40)).astype(np.int32)
    want = np.asarray(B.xla_refine_rerank(
        jr.flat, jr.res4, jr.res_scales, jr.offsets, jr.lengths, jnp.asarray(q),
        jnp.asarray(qmask), jnp.asarray(cand), jr.max_len, doc_scales=jr.scales))
    got = refine_rerank(pr.flat, pr.res4, pr.res_scales, pr.offsets, pr.lengths, _t(q),
                        _t(qmask), _t(cand), pr.max_len, pr.scales).numpy()
    real = cand >= 0
    np.testing.assert_allclose(got[real], want[real], **TOL)
    assert (got[~real] == NEG_INF).all()


def test_refine_is_step_independent(seals, monkeypatch):
    """A pair's refined score does not depend on how the pairs are cut into
    steps (the window budget) or on its position in the window."""
    import visual_rag_tpu_torch.ops.kernels.refine as refine

    pr = carried(seals["int8_refined"], "int8_refined").store("initial")
    q, qmask = _padded_queries(9, 4, 16)
    cand = np.random.default_rng(10).permutation(30)[:24].reshape(4, 6).astype(np.int32)
    args = (pr.flat, pr.res4, pr.res_scales, pr.offsets, pr.lengths, _t(q), _t(qmask))
    whole = refine_rerank(*args, _t(cand), pr.max_len, pr.scales)
    flipped = refine_rerank(*args, _t(cand[:, ::-1].copy()), pr.max_len, pr.scales)
    torch.testing.assert_close(flipped, whole.flip(1), rtol=0, atol=0)
    monkeypatch.setattr(refine, "REFINE_BUDGET_BYTES", 1)  # one pair a step
    torch.testing.assert_close(refine_rerank(*args, _t(cand), pr.max_len, pr.scales), whole,
                               **TOL)


def test_refine_window():
    """``max(32, 2k)`` candidates, at most the candidate count (trap 6)."""
    assert [refine_window(k, 200) for k in (1, 10, 16, 17, 50)] == [32, 32, 32, 34, 100]
    assert refine_window(10, 12) == 12 and refine_window(10, 0) == 1


# -- the traps of an int8 store --------------------------------------------------------


@pytest.fixture(scope="module")
def int8_pair(seals):
    jidx = seals["int8"]
    return jidx, carried(jidx, "int8")


def _jax_fused(jidx, name):
    from visual_rag_tpu.retrieval import RetrievalEngine as JaxEngine

    return JaxEngine(jidx, compute_dtype="float32")._fused_arrays(name)


def test_trap_pooled_stage1_rounds_to_bf16_and_scales(int8_pair):
    """Traps 1 and 2: the pooled stage-1 over int8 codes takes bf16 queries
    and multiplies each similarity by its row's scale before the max
    (``sharded.py:341-351``)."""
    jidx, p = int8_pair
    pooled = np.random.default_rng(3).standard_normal((6, DIM)).astype(np.float32)
    pooled /= np.linalg.norm(pooled, axis=1, keepdims=True)
    for name in ("mean_pooling", "experimental_pooling"):
        s1 = RetrievalEngine(p)._fused_arrays(name)
        assert s1["vals_t"].dtype == torch.int8 and s1["scales_t"].dtype == torch.float32
        want = np.asarray(S._local_pooled_padded(_jax_fused(jidx, name), jnp.asarray(pooled)))
        got = local.local_pooled_padded(s1, _t(pooled)).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_trap_gathered_stage2_rounds_to_bf16(int8_pair):
    """Trap 1 in ``three_stage``'s stage-2: the candidates' int8 pooled rows
    against bf16 queries (``sharded.py:397-414``)."""
    jidx, p = int8_pair
    q, qmask = _padded_queries(5, 4, 16)
    cand = np.random.default_rng(7).integers(-1, 30, (4, 12)).astype(np.int32)
    name = "experimental_pooling"
    want = np.asarray(S._gathered_tokens_padded(_jax_fused(jidx, name), jnp.asarray(q),
                                                jnp.asarray(qmask), jnp.asarray(cand)))
    got = local.gathered_tokens_padded(RetrievalEngine(p)._fused_arrays(name), _t(q),
                                       _t(qmask), _t(cand)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_trap_rerank_and_scan_take_the_doc_scales(int8_pair):
    """Trap 3: ``local_rerank`` and ``local_tokens_ragged`` pass the per-doc
    scales. The rerank against the Pallas kernel in interpret mode (bf16
    queries), the scan against the XLA scan (``sharded.py:580-634``)."""
    jidx, p = int8_pair
    ragged = RetrievalEngine(p)._fused_arrays("initial")
    assert ragged["scales"].dtype == torch.float32 and "res4" not in ragged
    jr = jidx.store("initial")
    q, qmask = _padded_queries(8, 4, 16)
    cand = np.random.default_rng(9).integers(0, 30, (4, 10)).astype(np.int32)
    want = np.asarray(jax_rerank(jr.flat, jr.offsets, jr.lengths, jnp.asarray(q),
                                 jnp.asarray(qmask), jnp.asarray(cand), jr.max_len,
                                 doc_scales=jr.scales, interpret=True))
    got = local.local_rerank(ragged, _t(q), _t(qmask), _t(cand), "plain", None, 4).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jrag = {"flat": jr.flat, "offsets": jr.offsets, "lengths": jr.lengths,
            "scales": jr.scales}
    want = np.asarray(S._local_tokens_ragged(jrag, jnp.asarray(q), jnp.asarray(qmask), None,
                                             jr.max_len))
    got = local.local_tokens_ragged(ragged, _t(q), _t(qmask), None, 4).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_trap_single_vector_int8_is_dequantized(int8_pair):
    """Trap 5: the JAX engine dequantizes an int8 single-vector store and
    applies no scale after (``batch.py:631-632``); so does the port."""
    jidx, p = int8_pair
    st = p.store("global_pooling")
    assert isinstance(st, SingleVectors) and st.values.dtype == torch.int8
    s1 = RetrievalEngine(p)._fused_arrays("global_pooling")
    assert set(s1) == {"vals"} and s1["vals"].dtype == torch.float32
    np.testing.assert_array_equal(s1["vals"].numpy(),
                                  np.asarray(_jax_fused(jidx, "global_pooling")["vals"]))
    pooled = np.random.default_rng(4).standard_normal((3, DIM)).astype(np.float32)
    want = np.asarray(S._local_pooled_single(_jax_fused(jidx, "global_pooling"),
                                             jnp.asarray(pooled)))
    np.testing.assert_allclose(local.local_pooled_single(s1, _t(pooled)).numpy(), want, **TOL)


def test_qdot_runs_only_on_a_prefetch_over_int8(int8_pair, monkeypatch):
    """The tokens stage-1 goes qdot for a prefetch over int8 codes only, and
    not once ``VISUALRAG_TOKENS_QDOT=0`` was read (module flag); the scan
    goes qdot on int8_refined stores only."""
    _, p = int8_pair
    s1 = RetrievalEngine(p)._fused_arrays("mean_pooling")
    ragged = RetrievalEngine(p)._fused_arrays("initial")
    q, qmask = _padded_queries(11, 2, 8)
    seen = []
    monkeypatch.setattr(local, "pooled_maxsim_scores_qbatch",
                        lambda *a, qdot_int8: seen.append(qdot_int8) or torch.zeros(2, 30))
    monkeypatch.setattr(local, "exhaustive_scores_packed",
                        lambda *a, qdot_int8: seen.append(qdot_int8) or torch.zeros(2, 30))
    args = (s1, ragged, _t(q), _t(qmask), None, None, 2)
    local.local_stage1("tokens_padded", *args, s1_prefetch=True)
    local.local_stage1("tokens_padded", *args)
    local.local_stage1("tokens_ragged", *args)
    local.local_stage1("tokens_ragged", s1, dict(ragged, res4=0), *args[2:])
    monkeypatch.setattr(local, "TOKENS_QDOT", False)
    local.local_stage1("tokens_padded", *args, s1_prefetch=True)
    assert seen == [True, False, False, True, False]
