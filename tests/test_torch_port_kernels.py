"""The port's kernel modules on the CPU (their plain PyTorch versions) vs the
JAX package: the Pallas kernels in interpret mode and the XLA fallbacks.

Inputs come from numpy with a seed and go to both sides. f32 store, f32
math on both sides: only the order of summation differs, so scores agree
to 1e-5. Cases: -1 candidates, 0-token docs (the last one included), a
partial qmask, a max_len that is not a multiple of 32, per-doc scales.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_rag_tpu.ops.kernels.maxsim_rerank import rerank_candidates as jax_rerank
from visual_rag_tpu.ops.kernels.maxsim_scan import exhaustive_scores_packed as jax_scan
from visual_rag_tpu.retrieval import batch as B
from visual_rag_tpu_torch.ops.kernels.maxsim_rerank import (
    rerank_candidates,
    rerank_candidates_ref,
)
from visual_rag_tpu_torch.ops.kernels.maxsim_scan import (
    exhaustive_scores_packed,
    exhaustive_scores_packed_ref,
)
from visual_rag_tpu_torch.retrieval import wire

torch.set_num_threads(1)  # tier-1 runs several test workers at once

DIM = 128
TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF = -1e30


def _store(seed=0, n_docs=30):
    """Ragged f32 store in the JAX layout: 32-row-aligned docs, tail pad of
    ceil32(max_len) rows, three empty docs (the last one included) and a
    max_len of 77."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 70, n_docs).astype(np.int32)
    lengths[[2, 9, n_docs - 1]] = 0
    lengths[4] = 77
    aligned = (lengths + 31) // 32 * 32
    offsets = np.concatenate([[0], np.cumsum(aligned[:-1])]).astype(np.int32)
    max_len = int(lengths.max())
    rows = int(aligned.sum()) + (max_len + 31) // 32 * 32
    flat = rng.standard_normal((rows, DIM)).astype(np.float32)
    flat /= np.linalg.norm(flat, axis=1, keepdims=True)
    scales = rng.uniform(0.5, 2.0, n_docs).astype(np.float32)
    return flat, offsets, lengths, max_len, scales


def _padded_queries(seed, b, nq):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nq, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qmask = np.ones((b, nq), np.float32)
    qmask[0, nq // 2:] = 0.0  # a partial mask
    qmask[1, -1] = 0.0
    return q, qmask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("with_scales", [False, True])
def test_rerank_plain_matches_pallas_interpret(with_scales):
    flat, offs, lens, max_len, scales = _store()
    q, qmask = _padded_queries(1, 3, 16)
    rng = np.random.default_rng(2)
    cand = rng.integers(-1, 30, (3, 21)).astype(np.int32)
    cand[:, 0] = 9  # an empty doc in every row
    cand[:, 1] = 29  # the last doc, also empty
    sc = scales if with_scales else None
    want = np.asarray(jax_rerank(
        jnp.asarray(flat), jnp.asarray(offs), jnp.asarray(lens), jnp.asarray(q),
        jnp.asarray(qmask), jnp.asarray(cand), max_len,
        doc_scales=None if sc is None else jnp.asarray(sc), interpret=True))
    got = rerank_candidates_ref(*_t(flat, offs, lens, q, qmask, cand), max_len,
                                None if sc is None else torch.from_numpy(sc))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got.numpy()[cand < 0] == NEG_INF).all()
    assert (got.numpy()[:, :2] == NEG_INF).all()


def test_rerank_plain_matches_xla_fallback():
    """xla_rerank_batch scores a valid 0-token candidate 0.0 where the kernels
    (and the port) score NEG_INF; everywhere else they agree."""
    flat, offs, lens, max_len, scales = _store(seed=3)
    q, qmask = _padded_queries(4, 4, 24)
    cand = np.random.default_rng(5).integers(-1, 30, (4, 40)).astype(np.int32)
    want = np.asarray(B.xla_rerank_batch(
        jnp.asarray(flat), jnp.asarray(offs), jnp.asarray(lens), jnp.asarray(q),
        jnp.asarray(qmask), jnp.asarray(cand), max_len, scales=jnp.asarray(scales),
        chunk=8))
    got = rerank_candidates_ref(*_t(flat, offs, lens, q, qmask, cand), max_len,
                                torch.from_numpy(scales)).numpy()
    real = (cand >= 0) & (lens[np.maximum(cand, 0)] > 0)
    np.testing.assert_allclose(got[real], want[real], **TOL)
    assert (got[~real] == NEG_INF).all()
    assert (want[(cand >= 0) & ~real] == 0.0).all()


def test_rerank_wrapper_runs_the_plain_version_on_cpu():
    flat, offs, lens, max_len, _ = _store()
    q, qmask = _padded_queries(1, 2, 8)
    cand = np.arange(20, dtype=np.int32).reshape(2, 10)
    args = (*_t(flat, offs, lens, q, qmask, cand), max_len)
    before = rerank_candidates.launches
    torch.testing.assert_close(rerank_candidates(*args), rerank_candidates_ref(*args),
                               rtol=0, atol=0)
    assert rerank_candidates.launches == before  # the count is of kernel launches


def _packed_queries(seed, b):
    rng = np.random.default_rng(seed)
    qs = [rng.standard_normal((int(rng.integers(3, 30)), DIM)).astype(np.float32)
          for _ in range(b)]
    (packed, _, qid), _, _ = wire.pack_queries_grouped(qs, DIM)
    packed = packed / (np.linalg.norm(packed, axis=1, keepdims=True) + 1e-8)
    return packed.astype(np.float32), qid


@pytest.mark.parametrize("b,with_scales", [(8, False), (64, True)])
def test_scan_plain_matches_pallas_interpret(b, with_scales):
    flat, offs, lens, max_len, scales = _store(seed=6)
    packed, qid = _packed_queries(7, b)
    sc = scales if with_scales else None
    want = np.asarray(jax_scan(
        jnp.asarray(flat), jnp.asarray(offs), jnp.asarray(lens), jnp.asarray(packed),
        jnp.asarray(qid), max_len, b=b,
        doc_scales=None if sc is None else jnp.asarray(sc), interpret=True))
    got = exhaustive_scores_packed_ref(*_t(flat, offs, lens, packed, qid), max_len, b,
                                       None if sc is None else torch.from_numpy(sc))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got.numpy()[:, lens == 0] == NEG_INF).all()


def test_scan_plain_matches_xla_fallback():
    flat, offs, lens, max_len, scales = _store(seed=8)
    b = 32
    packed, qid = _packed_queries(9, b)
    g, rg = qid.shape
    seg = (qid[:, None, :] == np.arange(b // g)[None, :, None]).astype(np.float32)
    want = np.asarray(B.xla_exhaustive_packed(
        jnp.asarray(flat), jnp.asarray(offs), jnp.asarray(lens), jnp.asarray(packed),
        jnp.asarray(seg), max_len, scales=jnp.asarray(scales), chunk=4))
    got = exhaustive_scores_packed(*_t(flat, offs, lens, packed, qid), max_len, b,
                                   torch.from_numpy(scales))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_scan_plain_is_chunk_independent(monkeypatch):
    """The plain scan bounds its f32 similarity tile by chunking over docs;
    a chunk of 1 doc gives the same scores (the matmul's blocking, and so
    its summation order, depends on the chunk's shape)."""
    import visual_rag_tpu_torch.ops.kernels.maxsim_scan as scan

    flat, offs, lens, max_len, _ = _store(seed=10)
    packed, qid = _packed_queries(11, 16)
    args = (*_t(flat, offs, lens, packed, qid), max_len, 16)
    whole = exhaustive_scores_packed_ref(*args)
    monkeypatch.setattr(scan, "_SIMS_BUDGET_BYTES", 1)
    torch.testing.assert_close(exhaustive_scores_packed_ref(*args), whole, **TOL)


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    flat, offs, lens, max_len, _ = _store()
    meta = torch.empty(flat.shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        exhaustive_scores_packed(meta, *_t(offs, lens), torch.empty((128, DIM)),
                                 torch.zeros((1, 128), dtype=torch.int32), max_len, 1)
