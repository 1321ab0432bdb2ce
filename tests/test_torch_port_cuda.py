"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device. On a machine with
one (no jax needed there):

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Shapes are small but cover what the kernels special-case: -1 candidates,
0-token docs (also last), a max_len that is not a multiple of 32, queries
of fewer than 8, 24 and more than 32 tokens (query tiles of 8-32 rows),
queries whose f32 tile needs more than 48 KB of shared memory, per-doc
scales, and every float storage dtype. The tokens stage-1 kernel (K5, K6,
K7): P = 4, 13 and 76 pooled rows, mask holes, docs with no valid row
(scored 0), a doc count that is not a multiple of the 64-doc block, pad
rows, groups of 8 to 768 rows, per-row scales; two calls bit-equal.

int8 stores: the int8 bodies (bf16 queries) of K1, K2 and K5/K6/K7 and the
qdot bodies (int8 queries, integer dots) of K1 and K5/K6/K7 (K9) against
their plain versions, each counted on its own counter; with one query row
a group, the qdot scores equal the plain version's bit for bit (the integer
dots are exact on both sides). The engine over int8 and int8_refined
stores on the card against the same index on the CPU.

K3 (dedup) and K4 (sweep): each against its plain version and bit-equal to
K2 on the same inputs, on f32, bf16, f16 and int8 stores, with heavy
sharing (runs cut at 16 pairs of one doc, ranges of many pairs), -1 and
0-token candidates, one range and many ranges, queries of 3 to 130 tokens;
two calls bit-equal; launch counts; the inputs the wrappers refuse; the
engine with each on the card against the CPU.

K10 (flash attention): against its plain version in f32 and bf16, causal and
not, per-tile segments with pads, grouped kv heads, T not a multiple of 64,
strided q/k/v views, and rows whose only allowed key is themselves (output
= v exactly); two calls bit-equal; launch counts; ``mha`` on CUDA tensors
raises when the kernel refuses a shape instead of running the plain
version; a small ColSmol-shaped model (head dim 64) on the card against the
CPU, with one K10 launch per attention layer.
"""

import numpy as np
import pytest
import torch

from visual_rag_tpu_torch import RetrievalEngine, synthetic_index
from visual_rag_tpu_torch.index.quantize import quantize_per_doc, quantize_rows_int8
from visual_rag_tpu_torch.ops.kernels.maxsim_rerank import (
    rerank_candidates,
    rerank_candidates_dedup,
    rerank_candidates_dedup_ref,
    rerank_candidates_ref,
)
from visual_rag_tpu_torch.ops.kernels.maxsim_scan import (
    exhaustive_scores_packed,
    exhaustive_scores_packed_ref,
)
from visual_rag_tpu_torch.ops.kernels import prefetch_topk as pt
from visual_rag_tpu_torch.ops.kernels.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from visual_rag_tpu_torch.ops.kernels.maxsim_sweep import (
    rerank_candidates_sweep,
    rerank_candidates_sweep_ref,
)
from visual_rag_tpu_torch.retrieval import plans, wire
from visual_rag_tpu_torch.retrieval.engine import SEARCH_MODES, STAGE1_MODES
from visual_rag_tpu_torch.retrieval.filters import build_filter
from visual_rag_tpu_torch.retrieval.oracle import strict_rank_equal

pytestmark = pytest.mark.cuda

DIM = 128
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# f32 stores: both sides f32, only the summation order differs; 2-byte
# stores: same exact products, f32 sums of up to ~130 tokens of |x| <= 1
ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3, torch.float16: 1e-3}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _store(dtype, dev, seed=0, n_docs=37):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 90, n_docs).astype(np.int32)
    lengths[[3, 11, n_docs - 1]] = 0  # empty docs, the last one included
    lengths[5] = 77  # max_len not a multiple of 32
    aligned = (lengths + 31) // 32 * 32
    offsets = np.concatenate([[0], np.cumsum(aligned[:-1])]).astype(np.int32)
    max_len = int(lengths.max())
    rows = int(aligned.sum()) + (max_len + 31) // 32 * 32
    flat = rng.standard_normal((rows, DIM)).astype(np.float32)
    flat /= np.linalg.norm(flat, axis=1, keepdims=True)
    return (torch.from_numpy(flat).to(dtype).to(dev), torch.from_numpy(offsets).to(dev),
            torch.from_numpy(lengths).to(dev), max_len)


def _queries(rng, n, lo, hi):
    return [rng.standard_normal((int(rng.integers(lo, hi + 1)), DIM)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nq_range", [(3, 6), (8, 24), (30, 45), (100, 130)])
def test_rerank_matches_plain(dev, dtype, nq_range):
    flat, offs, lens, max_len = _store(dtype, dev)
    rng = np.random.default_rng(1)
    raw, qmask = wire.to_device(wire.pad_queries_raw(_queries(rng, 6, *nq_range), DIM), dev)
    tokens, _ = plans._prep_queries(raw, qmask)
    cand = torch.from_numpy(rng.integers(-1, 37, (6, 19)).astype(np.int32))
    cand[:, 0] = 3  # an empty doc in every row
    cand = cand.to(dev)
    scales = torch.from_numpy(rng.uniform(0.5, 2.0, 37).astype(np.float32)).to(dev)
    for sc in (None, scales):
        args = (flat, offs, lens, tokens, qmask, cand, max_len, sc)
        got = rerank_candidates(*args)
        want = rerank_candidates_ref(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL[dtype])
        assert (got[cand < 0] == -1e30).all() and (got[:, 0] == -1e30).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [8, 64])
def test_scan_matches_plain_and_is_deterministic(dev, dtype, b):
    flat, offs, lens, max_len = _store(dtype, dev, seed=2)
    rng = np.random.default_rng(3)
    (p, pos, qid), nq, _ = wire.pack_queries_grouped(_queries(rng, b, 5, 40), DIM)
    packed = plans._prep_queries_packed(*wire.to_device((p, pos, qid), dev), b, nq)[3]
    scales = torch.from_numpy(rng.uniform(0.5, 2.0, 37).astype(np.float32)).to(dev)
    for sc in (None, scales):
        args = (flat, offs, lens, packed["q"], packed["qid"], max_len, b, sc)
        got = exhaustive_scores_packed(*args)
        again = exhaustive_scores_packed(*args)
        want = exhaustive_scores_packed_ref(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL[dtype])
        assert torch.equal(got, again)
        assert (got[:, lens == 0] == -1e30).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    flat, offs, lens, max_len = _store(torch.float32, dev)
    tokens = torch.zeros((2, 8, DIM), device=dev)
    qmask = torch.ones((2, 8), device=dev)
    cand = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        rerank_candidates(flat, offs.long(), lens, tokens, qmask, cand, max_len)
    with pytest.raises(ValueError, match="contiguous"):
        rerank_candidates(flat[:, ::2], offs, lens, tokens[..., ::2], qmask, cand, max_len)
    with pytest.raises(ValueError, match="store dtype"):
        exhaustive_scores_packed(flat.to(torch.float64), offs, lens, tokens[0], qmask.int(),
                                 max_len, 1)
    shifted = torch.zeros(2 * 8 * DIM + 1, device=dev)[1:].view(2, 8, DIM)
    with pytest.raises(ValueError, match="aligned"):
        rerank_candidates(flat, offs, lens, shifted, qmask, cand, max_len)


def _pooled_store(p, dtype, dev, seed=0, n_docs=203):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((p, n_docs, DIM)).astype(np.float32)
    vals /= np.linalg.norm(vals, axis=-1, keepdims=True)
    mask = rng.random((p, n_docs)) > 0.3
    mask[:, [5, n_docs - 1]] = False  # docs with no valid pooled row
    scales = rng.uniform(0.5, 2.0, (p, n_docs)).astype(np.float32)
    return (torch.from_numpy(vals).to(dtype).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(scales).to(dev))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [4, 13, 76])
@pytest.mark.parametrize("b,nq_range", [(8, (3, 8)), (64, (8, 24))])
def test_pooled_packed_matches_plain_and_is_deterministic(dev, dtype, p, b, nq_range):
    vals, mask, scales = _pooled_store(p, dtype, dev)
    rng = np.random.default_rng(p)
    (q, pos, qid), nq, _ = wire.pack_queries_grouped(_queries(rng, b, *nq_range), DIM)
    packed = plans._prep_queries_packed(*wire.to_device((q, pos, qid), dev), b, nq)[3]
    for sc in (None, scales):
        args = (vals, mask, packed["q"], packed["qid"], b, packed["w"], sc)
        got = pt.pooled_maxsim_scores_packed(*args)
        again = pt.pooled_maxsim_scores_packed(*args)
        want = pt.pooled_maxsim_scores_packed_ref(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL[dtype])
        assert torch.equal(got, again)
        assert (got[:, ~mask.any(dim=0)] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nq_range", [(3, 8), (20, 40), (100, 130)])
def test_pooled_padded_entry_points_match_plain(dev, dtype, nq_range):
    vals, mask, scales = _pooled_store(13, dtype, dev, seed=1)
    rng = np.random.default_rng(2)
    raw, qmask = wire.to_device(wire.pad_queries_raw(_queries(rng, 16, *nq_range), DIM), dev)
    tokens, _ = plans._prep_queries(raw, qmask)
    for sc in (None, scales):
        want = pt.pooled_maxsim_scores_packed_ref(
            vals, mask, *pt._as_packed(vals, tokens, qmask), scales_t=sc)
        for fn in (pt.pooled_maxsim_scores_qbatch, pt.pooled_maxsim_scores):
            got = fn(vals, mask, tokens, qmask, sc)
            again = fn(vals, mask, tokens, qmask, sc)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=0, atol=ATOL[dtype])
            assert torch.equal(got, again)


def test_pooled_wrappers_count_launches(dev):
    vals, mask, _ = _pooled_store(4, torch.float32, dev)
    tokens = torch.nn.functional.normalize(torch.randn((2, 8, DIM), device=dev), dim=-1)
    qmask = torch.ones((2, 8), device=dev)
    before = (pt.pooled_maxsim_scores_qbatch.launches, pt.pooled_maxsim_scores.launches)
    pt.pooled_maxsim_scores_qbatch(vals, mask, tokens, qmask)
    pt.pooled_maxsim_scores(vals, mask, tokens, qmask)
    pt.pooled_maxsim_scores_packed_ref(vals, mask, *pt._as_packed(vals, tokens, qmask))
    assert (pt.pooled_maxsim_scores_qbatch.launches, pt.pooled_maxsim_scores.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="mask_t"):
        pt.pooled_maxsim_scores(vals, mask[:2], tokens, qmask)
    with pytest.raises(ValueError, match="store dtype"):
        pt.pooled_maxsim_scores(vals.double(), mask, tokens, qmask)


@pytest.mark.parametrize("query_wire", ["padded", "packed"])
def test_every_mode_on_card_matches_cpu(dev, query_wire):
    idx = synthetic_index(150, min_tokens=20, max_tokens=300, pooled_rows=6,
                          storage_dtype="float32", seed=7, device="cpu")
    for i, pl in enumerate(idx.manifest.payloads):
        pl["year"] = 2020 + i % 4
    qs = _queries(np.random.default_rng(8), 40, 8, 24)
    card, cpu = (RetrievalEngine(i, query_wire=query_wire) for i in (idx.to(dev), idx))
    cuts = dict(top_k=10, prefetch_k=40, stage1_k=60, stage2_k=30, with_payload=False)
    runs = [dict(mode=m) for m in SEARCH_MODES] + [
        dict(mode="two_stage", stage1_mode=s) for s in STAGE1_MODES] + [
        dict(mode="two_stage", filter_obj=build_filter(year=[2021, 2023]))]
    for kw in runs:
        key = "score" if kw["mode"].startswith("single_") else "score_final"
        for a, c in zip(card.search_embedded_batch(qs, **kw, **cuts),
                        cpu.search_embedded_batch(qs, **kw, **cuts)):
            assert strict_rank_equal([dict(h, score=h[key]) for h in c], a, score_tol=1e-4), kw


@pytest.mark.parametrize("query_wire", ["padded", "packed"])
def test_engine_on_card_matches_cpu(dev, query_wire):
    # float32 (see chip_smoke.py): with a 2-byte store the two devices' query
    # normalisations may round to different store values
    idx = synthetic_index(150, min_tokens=20, max_tokens=300, pooled_rows=6,
                          storage_dtype="float32", seed=5, device="cpu")
    qs = _queries(np.random.default_rng(6), 40, 8, 24)
    card, cpu = (RetrievalEngine(i, query_wire=query_wire) for i in (idx.to(dev), idx))
    for mode, key in (("two_stage", "score_final"), ("single_full", "score")):
        kw = dict(mode=mode, top_k=10, prefetch_k=150, with_payload=False)
        for a, c in zip(card.search_embedded_batch(qs, **kw),
                        cpu.search_embedded_batch(qs, **kw)):
            assert strict_rank_equal([dict(h, score=h[key]) for h in c], a, score_tol=1e-4)


# -- int8 stores -------------------------------------------------------------------

INT8_ATOL = 1e-3  # exact products on both sides, f32 sums in another order


def _int8_store(dev, seed=0):
    flat, offs, lens, max_len = _store(torch.float32, "cpu", seed=seed)
    codes, scales = quantize_per_doc(flat, offs, lens)
    return codes.to(dev), offs.to(dev), lens.to(dev), max_len, scales.to(dev)


def test_rerank_int8_matches_plain(dev):
    codes, offs, lens, max_len, scales = _int8_store(dev)
    rng = np.random.default_rng(1)
    raw, qmask = wire.to_device(wire.pad_queries_raw(_queries(rng, 6, 8, 40), DIM), dev)
    tokens, _ = plans._prep_queries(raw, qmask)
    cand = torch.from_numpy(rng.integers(-1, 37, (6, 19)).astype(np.int32)).to(dev)
    args = (codes, offs, lens, tokens, qmask, cand, max_len, scales)
    before = rerank_candidates.launches
    got, want = rerank_candidates(*args), rerank_candidates_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=INT8_ATOL)
    assert rerank_candidates.launches == before + 1


@pytest.mark.parametrize("qdot", [False, True])
@pytest.mark.parametrize("b", [8, 64])
def test_scan_int8_matches_plain(dev, qdot, b):
    codes, offs, lens, max_len, scales = _int8_store(dev, seed=2)
    rng = np.random.default_rng(3)
    (p, pos, qid), nq, _ = wire.pack_queries_grouped(_queries(rng, b, 5, 40), DIM)
    packed = plans._prep_queries_packed(*wire.to_device((p, pos, qid), dev), b, nq)[3]
    args = (codes, offs, lens, packed["q"], packed["qid"], max_len, b, scales)
    counter = "launches_qdot" if qdot else "launches"
    before = getattr(exhaustive_scores_packed, counter)
    got = exhaustive_scores_packed(*args, qdot_int8=qdot)
    again = exhaustive_scores_packed(*args, qdot_int8=qdot)
    want = exhaustive_scores_packed_ref(*args, qdot_int8=qdot)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=INT8_ATOL)
    assert torch.equal(got, again) and (got[:, lens == 0] == -1e30).all()
    assert getattr(exhaustive_scores_packed, counter) == before + 2
    if qdot:  # one row a group: w * (rowmax * scale) on both sides, rowmax exact
        m = packed["q"].shape[0]
        rows = (packed["q"], (packed["qid"].reshape(-1, 1) >= 0).int() - 1, max_len, m, scales)
        torch.testing.assert_close(
            exhaustive_scores_packed(codes, offs, lens, *rows, qdot_int8=True),
            exhaustive_scores_packed_ref(codes, offs, lens, *rows, qdot_int8=True),
            rtol=0, atol=0)


def _pooled_int8_store(p, dev, seed=0):
    vals, mask, _ = _pooled_store(p, torch.float32, "cpu", seed=seed)
    codes, scales = quantize_rows_int8(vals)
    return codes.to(dev), mask.to(dev), scales.to(dev)


@pytest.mark.parametrize("qdot", [False, True])
@pytest.mark.parametrize("p", [4, 13, 76])
def test_pooled_int8_matches_plain(dev, p, qdot):
    """K5 (packed), K6 and K7 (padded) over int8 codes, and their qdot body
    (K9's function), each on its own counter."""
    vals, mask, scales = _pooled_int8_store(p, dev)
    rng = np.random.default_rng(p)
    (q, pos, qid), nq, _ = wire.pack_queries_grouped(_queries(rng, 64, 8, 24), DIM)
    packed = plans._prep_queries_packed(*wire.to_device((q, pos, qid), dev), 64, nq)[3]
    counter = "launches_qdot" if qdot else "launches"
    args = (vals, mask, packed["q"], packed["qid"], 64, packed["w"], scales)
    before = getattr(pt.pooled_maxsim_scores_packed, counter)
    got = pt.pooled_maxsim_scores_packed(*args, qdot_int8=qdot)
    again = pt.pooled_maxsim_scores_packed(*args, qdot_int8=qdot)
    want = pt.pooled_maxsim_scores_packed_ref(*args, qdot_int8=qdot)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=INT8_ATOL)
    assert torch.equal(got, again) and (got[:, ~mask.any(dim=0)] == 0).all()
    assert getattr(pt.pooled_maxsim_scores_packed, counter) == before + 2
    raw, qmask = wire.to_device(wire.pad_queries_raw(_queries(rng, 16, 3, 40), DIM), dev)
    tokens, _ = plans._prep_queries(raw, qmask)
    want = pt.pooled_maxsim_scores_packed_ref(vals, mask, *pt._as_packed(vals, tokens, qmask),
                                              scales_t=scales, qdot_int8=qdot)
    for fn in (pt.pooled_maxsim_scores_qbatch, pt.pooled_maxsim_scores):
        before = getattr(fn, counter)
        got = fn(vals, mask, tokens, qmask, scales, qdot_int8=qdot)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=INT8_ATOL)
        assert getattr(fn, counter) == before + 1
    if qdot:  # one row a group: w * rowmax on both sides, rowmax exact
        m = packed["q"].shape[0]
        rows = (vals, mask, packed["q"], torch.zeros((m, 1), dtype=torch.int32, device=dev), m,
                None, scales)
        torch.testing.assert_close(pt.pooled_maxsim_scores_packed(*rows, qdot_int8=True),
                                   pt.pooled_maxsim_scores_packed_ref(*rows, qdot_int8=True),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("storage_dtype", ["int8", "int8_refined"])
@pytest.mark.parametrize("query_wire", ["padded", "packed"])
def test_engine_int8_on_card_matches_cpu(dev, storage_dtype, query_wire):
    """Every mode, every stage-1 mode and a filter over int8 stores: the
    card against the same index on the CPU. 1e-3: a query normalised on
    each device can round to a different bf16 value or int8 code."""
    idx = synthetic_index(150, min_tokens=20, max_tokens=300, pooled_rows=6,
                          storage_dtype=storage_dtype, seed=7, device="cpu")
    for i, pl in enumerate(idx.manifest.payloads):
        pl["year"] = 2020 + i % 4
    qs = _queries(np.random.default_rng(8), 40, 8, 24)
    card, cpu = (RetrievalEngine(i, query_wire=query_wire) for i in (idx.to(dev), idx))
    cuts = dict(top_k=10, prefetch_k=40, stage1_k=60, stage2_k=30, with_payload=False)
    runs = [dict(mode=m) for m in SEARCH_MODES] + [
        dict(mode="two_stage", stage1_mode=s) for s in STAGE1_MODES] + [
        dict(mode="two_stage", filter_obj=build_filter(year=[2021, 2023]))]
    for kw in runs:
        key = "score" if kw["mode"].startswith("single_") else "score_final"
        for a, c in zip(card.search_embedded_batch(qs, **kw, **cuts),
                        cpu.search_embedded_batch(qs, **kw, **cuts)):
            assert strict_rank_equal([dict(h, score=h[key]) for h in c], a, score_tol=1e-3), kw


# -- K3 (dedup) and K4 (sweep) -------------------------------------------------------


def _pair_candidates(rng, case, b, k, n_docs):
    if case == "heavy_sharing":  # 6 docs for every query: runs of 16, full ranges
        cand = rng.integers(0, 6, (b, k))
    else:
        cand = rng.integers(-1, n_docs, (b, k))
    cand[:, 0] = 3  # a 0-token doc in every row
    cand[0, 1:3] = [-1, n_docs - 1]  # padding; the last doc, also empty
    return torch.from_numpy(cand.astype(np.int32))


@pytest.mark.parametrize("dtype", DTYPES + (torch.int8,))
@pytest.mark.parametrize("case", ["heavy_sharing", "uniform"])
@pytest.mark.parametrize("r_step", [64, 4096])  # many ranges; one range (the store is small)
def test_dedup_and_sweep_match_plain_and_k2(dev, dtype, case, r_step):
    if dtype == torch.int8:
        flat, offs, lens, max_len, scales = _int8_store(dev, seed=4)
    else:
        flat, offs, lens, max_len = _store(dtype, dev, seed=4)
        scales = None
    rng = np.random.default_rng(5)
    for nq_range in ((3, 6), (8, 24), (100, 130)):
        raw, qmask = wire.to_device(wire.pad_queries_raw(_queries(rng, 20, *nq_range), DIM), dev)
        tokens, _ = plans._prep_queries(raw, qmask)
        cand = _pair_candidates(rng, case, 20, 23, 37).to(dev)
        args = (flat, offs, lens, tokens, qmask, cand, max_len, scales)
        k2 = rerank_candidates(*args)
        before = (rerank_candidates_dedup.launches, rerank_candidates_sweep.launches)
        k3, k3_again = rerank_candidates_dedup(*args), rerank_candidates_dedup(*args)
        k4 = rerank_candidates_sweep(*args, r_step=r_step)
        k4_again = rerank_candidates_sweep(*args, r_step=r_step)
        want3 = rerank_candidates_dedup_ref(*args)
        want4 = rerank_candidates_sweep_ref(*args, r_step=r_step)
        torch.cuda.synchronize()
        atol = INT8_ATOL if dtype == torch.int8 else ATOL[dtype]
        torch.testing.assert_close(k3, want3, rtol=0, atol=atol)
        torch.testing.assert_close(k4, want4, rtol=0, atol=atol)
        assert torch.equal(k3, k3_again) and torch.equal(k4, k4_again)
        # the same row dots, maxima and fold as K2: the same bits
        assert torch.equal(k3, k2), float((k3 - k2).abs().max())
        assert torch.equal(k4, k2), float((k4 - k2).abs().max())
        assert (k3[cand < 0] == -1e30).all() and (k3[:, 0] == -1e30).all()
        assert (rerank_candidates_dedup.launches, rerank_candidates_sweep.launches) == (
            before[0] + 2, before[1] + 2)


def test_pair_wrappers_refuse_what_the_kernels_do_not_take(dev):
    flat, offs, lens, max_len = _store(torch.float32, dev)
    tokens = torch.zeros((2, 8, DIM), device=dev)
    qmask = torch.ones((2, 8), device=dev)
    cand = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    long_q = torch.zeros((2, 1000, DIM), device=dev)
    for fn in (rerank_candidates_dedup, rerank_candidates_sweep):
        with pytest.raises(ValueError, match="int32"):
            fn(flat, offs.long(), lens, tokens, qmask, cand, max_len)
        with pytest.raises(ValueError, match="store dtype"):
            fn(flat.double(), offs, lens, tokens, qmask, cand, max_len)
        with pytest.raises(ValueError, match="qmask"):
            fn(flat, offs, lens, tokens, qmask[:, :4], cand, max_len)
        with pytest.raises(ValueError, match="does not"):
            fn(flat, offs, lens, long_q, torch.ones((2, 1000), device=dev), cand, max_len)
        with pytest.raises(ValueError, match="is on cpu"):
            fn(flat, offs, lens, tokens, qmask, cand.cpu(), max_len)


@pytest.mark.parametrize("impl", ["dedup", "sweep"])
@pytest.mark.parametrize("query_wire", ["padded", "packed"])
def test_engine_dedup_and_sweep_on_card_match_cpu(dev, impl, query_wire):
    idx = synthetic_index(150, min_tokens=20, max_tokens=300, pooled_rows=6,
                          storage_dtype="float32", seed=5, device="cpu")
    qs = _queries(np.random.default_rng(6), 70, 8, 24)
    card, cpu = (RetrievalEngine(i, query_wire=query_wire, rerank_impl=impl)
                 for i in (idx.to(dev), idx))
    before = getattr({"dedup": rerank_candidates_dedup,
                      "sweep": rerank_candidates_sweep}[impl], "launches")
    for mode in ("two_stage", "three_stage"):
        kw = dict(mode=mode, top_k=10, prefetch_k=60, stage1_k=80, stage2_k=40,
                  with_payload=False)
        for a, c in zip(card.search_embedded_batch(qs, **kw),
                        cpu.search_embedded_batch(qs, **kw)):
            assert strict_rank_equal([dict(h, score=h["score_final"]) for h in c], a,
                                     score_tol=1e-4)
    assert getattr({"dedup": rerank_candidates_dedup,
                    "sweep": rerank_candidates_sweep}[impl], "launches") == before + 2


# -- K10: flash attention ---------------------------------------------------------------

FA_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # bf16: ~2 ulps at |o| ~ 2


def _fa_inputs(dev, dtype, b, t, hq, hkv, seed, tile=None):
    """q, k, v as strided views of one fused [B, T, Hq + 2 Hkv, 64] tensor,
    and seg: per-tile segments (tile rows each) or two segments, then pads."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, t, hq + 2 * hkv, 64)).astype(np.float32))
    qkv = qkv.to(dev, dtype)
    q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    seg = np.zeros((b, t), np.int32)
    for i in range(b):
        n = t - int(rng.integers(0, t // 3))  # valid rows, then pads (segment 0)
        seg[i, :n] = (np.arange(n) // tile + 1) if tile else 1 + (np.arange(n) >= n // 2)
    return q, k, v, torch.from_numpy(seg).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,hq,hkv,tile", [(256, 4, 4, 64), (200, 6, 2, None),
                                           (1100, 3, 1, 96), (37, 2, 2, None)])
def test_flash_attention_matches_plain(dev, dtype, causal, t, hq, hkv, tile):
    q, k, v, seg = _fa_inputs(dev, dtype, 2, t, hq, hkv, seed=t + hq, tile=tile)
    before = flash_attention.launches
    got, again = (flash_attention(q, k, v, seg, causal=causal) for _ in range(2))
    want = flash_attention_plain(q, k, v, seg, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (2, t, hq, 64)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=FA_ATOL[dtype])
    assert torch.equal(got, again)
    assert flash_attention.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_row_with_only_itself(dev, dtype, causal):
    """Every row its own segment: softmax over one key, the output is v."""
    q, k, v, _ = _fa_inputs(dev, dtype, 1, 130, 4, 2, seed=3)
    seg = torch.arange(130, dtype=torch.int32, device=dev)[None]
    got = flash_attention(q, k, v, seg, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(got, v.repeat_interleave(2, dim=2))


def test_mha_on_cuda_raises_when_the_kernel_refuses(dev):
    from visual_rag_tpu_torch.models.attention import mha

    mask = torch.ones((1, 64), dtype=torch.bool, device=dev)
    x32 = torch.zeros((1, 64, 2, 32), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        mha(x32, x32, x32, mask, causal=True, dtype=torch.float32)
    x16 = torch.zeros((1, 64, 2, 64), device=dev)
    with pytest.raises(ValueError, match="f32 or bf16"):
        mha(x16, x16, x16, mask, causal=False, dtype=torch.float16)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="one device"):
        flash_attention(x16, x16, x16, mask.int().cpu(), causal=False)
    assert flash_attention.launches == before


def test_colsmol_shaped_model_on_card_matches_cpu(dev):
    """Head dim 64 in both towers, so every attention runs K10 on the card."""
    import dataclasses

    from visual_rag_tpu_torch.models.colvlm import ColVLMConfig
    from visual_rag_tpu_torch.models.convert import build_model, init_params

    tiny = ColVLMConfig.tiny()
    cfg = dataclasses.replace(
        tiny, dtype="float32", proj_bias=True, connector_bias=False,
        vision=dataclasses.replace(tiny.vision, hidden=128, heads=2, pixel_shuffle=2,
                                   max_patches=2048, attn_bias=True),
        text=dataclasses.replace(tiny.text, hidden=128, heads=2, kv_heads=1))
    sd = init_params(cfg, seed=1, device="cpu")
    card, cpu = build_model(cfg, sd, dev), build_model(cfg, sd, "cpu")
    rng = np.random.default_rng(2)
    n = 3 * 256
    patches = torch.from_numpy(rng.random((2, n, 48), dtype=np.float32))
    pmask = torch.ones((2, n), dtype=torch.bool)
    pmask[1, 512:] = False  # the second page has two tiles, then pads
    wids = torch.from_numpy(np.repeat(np.arange(3, dtype=np.int32), 256)[None].repeat(2, 0))
    ids = torch.full((2, 200), 7, dtype=torch.int32)
    ids[0, :192], ids[1, :128] = cfg.image_token_id, cfg.image_token_id
    amask = torch.ones((2, 200), dtype=torch.bool)
    amask[1, 140:] = False
    before = flash_attention.launches
    with torch.inference_mode():
        got = card.embed_pages(*(x.to(dev) for x in (ids, amask, patches, pmask, wids)))
        want = cpu.embed_pages(ids, amask, patches, pmask, wids)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.vision.layers + cfg.text.layers
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)
