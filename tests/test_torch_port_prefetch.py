"""The port's stage-1 kernels over the pooled store on the CPU vs the JAX package.

On CPU tensors the three entry points of ``ops/kernels/prefetch_topk.py``
run their plain PyTorch version. They are held against the JAX Pallas
kernels in interpret mode (``pooled_maxsim_scores_packed``,
``pooled_maxsim_scores_qbatch``, ``pooled_maxsim_scores``) and against the
XLA fallbacks ``_local_tokens_padded[_packed]`` of
``visual_rag_tpu/parallel/sharded.py``. Inputs come from numpy with a seed;
f32 store and f32 math on both sides, so only the order of summation
differs: 1e-5. Cases: P = 4, 13 and 76 pooled rows; 150 docs (not a
multiple of the 128/256-doc blocks); random mask holes and two docs with no
valid row (the last one included), which score 0; a partial qmask; pad
rows in packed groups; with and without per-row scales.

The pooled stage-1 (``pooled_stage1_scores``) on CPU tensors takes its plain
version and equals the JAX package's ``_local_pooled_padded`` on bf16, f16
and int8 stores (int8 with its row scales), and so does K6 with each pooled
query as a one-row query, which the card runs at rows other than 128 wide.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_rag_tpu.ops.kernels import prefetch_topk as jax_pt
from visual_rag_tpu.parallel.sharded import (
    _local_pooled_padded,
    _local_tokens_padded,
    _local_tokens_padded_packed,
)
from visual_rag_tpu_torch.index.quantize import quantize_rows_int8
from visual_rag_tpu_torch.ops.kernels import prefetch_topk as pt
from visual_rag_tpu_torch.retrieval import wire

torch.set_num_threads(1)  # tier-1 runs several test workers at once

DIM = 128
N_DOCS = 150
EMPTY = (7, N_DOCS - 1)  # docs with no valid pooled row
TOL = dict(rtol=1e-5, atol=1e-5)


def _store(p, seed=0, dim=DIM):
    """P-leading f32 pooled store [P, D, dim], a mask with holes, scales."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((p, N_DOCS, dim)).astype(np.float32)
    vals /= np.linalg.norm(vals, axis=-1, keepdims=True)
    mask = rng.random((p, N_DOCS)) > 0.3
    mask[0, :] = True  # most docs keep a valid row
    mask[:, list(EMPTY)] = False
    scales = rng.uniform(0.5, 2.0, (p, N_DOCS)).astype(np.float32)
    return vals, mask, scales


def _packed(seed=1, b=16, group=8):
    """Group-packed l2-normalised queries (pad rows 0) and their owners."""
    rng = np.random.default_rng(seed)
    qs = [rng.standard_normal((int(rng.integers(3, 21)), DIM)).astype(np.float32)
          for _ in range(b)]
    (q, _, qid), _, _ = wire.pack_queries_grouped(qs, DIM, group=group)
    q = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-8)
    seg = (qid[:, None, :] == np.arange(group)[None, :, None]).astype(np.float32)
    return q.astype(np.float32), qid, seg


def _padded(seed=2, b=8, nq=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nq, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qmask = np.ones((b, nq), np.float32)
    qmask[0, nq // 2:] = 0.0  # partial masks
    qmask[3, 1:] = 0.0
    qmask[b - 1, -1] = 0.0
    return q, qmask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("with_scales", [False, True])
@pytest.mark.parametrize("p", [4, 13, 76])
def test_packed_matches_jax(p, with_scales):
    vals, mask, scales = _store(p)
    q, qid, seg = _packed()
    sc = scales if with_scales else None
    got = pt.pooled_maxsim_scores_packed(_t(vals), _t(mask), _t(q), _t(qid), 16,
                                         scales_t=None if sc is None else _t(sc)).numpy()
    kernel = np.asarray(jax_pt.pooled_maxsim_scores_packed(
        jnp.asarray(vals), jnp.asarray(mask), jnp.asarray(q), jnp.asarray(seg),
        None if sc is None else jnp.asarray(sc), interpret=True))
    s1 = {"vals_t": jnp.asarray(vals), "mask_t": jnp.asarray(mask)}
    if sc is not None:
        s1["scales_t"] = jnp.asarray(sc)
    fallback = np.asarray(_local_tokens_padded_packed(s1, jnp.asarray(q), jnp.asarray(seg),
                                                      use_pallas=False))
    assert got.shape == (16, N_DOCS)
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, fallback, **TOL)
    assert (got[:, list(EMPTY)] == 0.0).all()


@pytest.mark.parametrize("with_scales", [False, True])
@pytest.mark.parametrize("p", [4, 13, 76])
def test_qbatch_matches_jax(p, with_scales):
    vals, mask, scales = _store(p, seed=3)
    q, qmask = _padded()
    sc = scales if with_scales else None
    got = pt.pooled_maxsim_scores_qbatch(_t(vals), _t(mask), _t(q), _t(qmask),
                                         None if sc is None else _t(sc)).numpy()
    kernel = np.asarray(jax_pt.pooled_maxsim_scores_qbatch(
        jnp.asarray(vals), jnp.asarray(mask), jnp.asarray(q), jnp.asarray(qmask),
        None if sc is None else jnp.asarray(sc), interpret=True))
    s1 = {"vals_t": jnp.asarray(vals), "mask_t": jnp.asarray(mask)}
    if sc is not None:
        s1["scales_t"] = jnp.asarray(sc)
    fallback = np.asarray(_local_tokens_padded(s1, jnp.asarray(q), jnp.asarray(qmask),
                                               use_pallas=False))
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, fallback, **TOL)
    assert (got[:, list(EMPTY)] == 0.0).all()


@pytest.mark.parametrize("p", [4, 13, 76])
def test_per_query_matches_jax(p):
    vals, mask, scales = _store(p, seed=4)
    q, qmask = _padded(seed=5, b=4, nq=8)
    got = pt.pooled_maxsim_scores(_t(vals), _t(mask), _t(q), _t(qmask), _t(scales)).numpy()
    kernel = np.asarray(jax_pt.pooled_maxsim_scores(
        jnp.asarray(vals), jnp.asarray(mask), jnp.asarray(q), jnp.asarray(qmask),
        jnp.asarray(scales), interpret=True))
    np.testing.assert_allclose(got, kernel, **TOL)
    # one function: the padded entry points equal the packed one, one query a group
    again = pt.pooled_maxsim_scores_qbatch(_t(vals), _t(mask), _t(q), _t(qmask), _t(scales))
    np.testing.assert_array_equal(got, again.numpy())


def test_row_weights_fold_into_the_sum():
    """``w`` scales each row's max before the per-query sum (the slot the
    int8 qdot variant folds its query scales into)."""
    vals, mask, _ = _store(13, seed=6)
    q, qid, _ = _packed(seed=7)
    w = np.random.default_rng(8).uniform(0.5, 2.0, q.shape[0]).astype(np.float32)
    args = (_t(vals), _t(mask), _t(q), _t(qid), 16)
    got = pt.pooled_maxsim_scores_packed(*args, w=_t(w)).numpy()
    per_row = pt.pooled_maxsim_scores_packed(
        _t(vals), _t(mask), _t(q), _t(np.where(qid >= 0, 0, -1).reshape(-1, 1)).int(),
        q.shape[0]).numpy()  # one row per group: the per-row maxima
    g, rg = qid.shape
    want = np.zeros((16, N_DOCS), np.float32)
    for m, owner in enumerate(qid.reshape(-1)):
        if owner >= 0:
            want[(m // rg) * 8 + owner] += w[m] * per_row[m]
    np.testing.assert_allclose(got, want, **TOL)


def _stage1_case(dtype, dim=DIM):
    """(the port's store, the JAX package's, 6 pooled queries): the P = 13
    store with holes and two empty docs in ``dtype``, int8 as codes with
    their row scales; every dot of doc 3 for query 1 is near -1."""
    vals, mask, _ = _store(13, dim=dim)
    rng = np.random.default_rng(5)
    pooled = rng.standard_normal((6, dim)).astype(np.float32)
    pooled /= np.linalg.norm(pooled, axis=1, keepdims=True)
    vals[:, 3] = -pooled[1]
    if dtype == "int8":
        codes, scales = quantize_rows_int8(_t(vals))
        s1 = {"vals_t": codes, "mask_t": _t(mask), "scales_t": scales}
        jax_s1 = {"vals_t": jnp.asarray(codes.numpy()), "mask_t": jnp.asarray(mask),
                  "scales_t": jnp.asarray(scales.numpy())}
    else:
        s1 = {"vals_t": _t(vals).to(getattr(torch, dtype)), "mask_t": _t(mask)}
        jax_s1 = {"vals_t": jnp.asarray(vals, dtype=dtype), "mask_t": jnp.asarray(mask)}
    return s1, jax_s1, pooled


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int8"])
def test_pooled_stage1_matches_jax(dtype):
    """The pooled query against the P = 13 store with holes and two empty
    docs: bf16 and f16 stores with queries rounded to their dtype, int8 codes
    with bf16 queries and each similarity times its row's scale. Exact
    products on both sides, f32 sums in another order: 1e-5."""
    s1, jax_s1, pooled = _stage1_case(dtype)
    before = pt.pooled_stage1_scores.launches
    got = pt.pooled_stage1_scores(s1["vals_t"], s1["mask_t"], _t(pooled), s1.get("scales_t"))
    want = np.asarray(_local_pooled_padded(jax_s1, jnp.asarray(pooled)))
    assert pt.pooled_stage1_scores.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got[:, list(EMPTY)] == 0).all() and float(got[1, 3]) < -0.5


@pytest.mark.parametrize("dim", [72, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int8"])
def test_k6_with_one_row_queries_is_the_pooled_stage1(dtype, dim):
    """On the card, a store of rows other than 128 wide takes K6 for the
    pooled stage-1, each pooled query a one-row query of weight 1. K6's
    function (its plain version here) is then the JAX package's
    ``_local_pooled_padded``, at 72 and at 128: 1e-5."""
    s1, jax_s1, pooled = _stage1_case(dtype, dim)
    got = pt.pooled_maxsim_scores_qbatch(s1["vals_t"], s1["mask_t"], _t(pooled)[:, None],
                                         torch.ones(6, 1), s1.get("scales_t"))
    want = np.asarray(_local_pooled_padded(jax_s1, jnp.asarray(pooled)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got[:, list(EMPTY)] == 0).all() and float(got[1, 3]) < -0.5


def test_wrappers_refuse_other_devices():
    vals, mask, _ = _store(4)
    q, qmask = _padded()
    meta = torch.empty(vals.shape, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pt.pooled_maxsim_scores_qbatch(meta, _t(mask), _t(q), _t(qmask))
    with pytest.raises(ValueError, match="qmask"):
        pt.pooled_maxsim_scores(_t(vals), _t(mask), _t(q), _t(qmask[:, :3]))


def test_kernel_geometry():
    """Rows a thread holds and the block's shared memory (csrc twins)."""
    assert [pt.rows_per_thread(r) for r in (8, 16, 24, 40, 64, 128, 768)] == [1, 1, 2, 4, 4, 8, 8]
    # the serving shape (groups of 32, dim 128) leaves room for two blocks an SM
    assert pt.smem_bytes(768, 128, 32) == 111360
    assert 2 * (pt.smem_bytes(768, 128, 32) + 1024) <= 228 * 1024
