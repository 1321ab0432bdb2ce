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

The pooled stage-1 kernel (``pooled_stage1_scores``): bf16, f16 and int8
stores (int8 with its row scales) against its plain version at batches of
1 to 1030, doc counts that are not a multiple of its 32-doc tile, P 1 to 76
with holes; docs with no valid row exactly 0, negative dots kept, two
calls bit-equal; an f32 store and a dim-72 bf16 store stay on the plain
loop without a launch; every pooled stage-1 mode through the engine
launches it and returns the plain loop's ids and scores, ``three_stage``
does not launch it.

int8 stores: the int8 bodies (bf16 queries) of K1, K2 and K5/K6/K7 and the
qdot bodies (int8 queries, integer dots) of K1 and K5/K6/K7 (K9) against
their plain versions, each counted on its own counter; with one query row
a group, the qdot scores equal the plain version's bit for bit (the integer
dots are exact on both sides). The engine over int8 and int8_refined
stores on the card against the same index on the CPU.

K3 (dedup) and K4 (sweep): each against its plain version on f32, bf16,
f16 and int8 stores, with heavy sharing (runs cut at the most a run holds,
ranges of many pairs), -1 and 0-token candidates, one range and many
ranges, queries of 3 to 130 tokens; K4, and K3 on f32 stores, bit-equal to
K2 on the same inputs; K3's tensor-core body (bf16, f16, int8 at dim 128:
the same exact products, f32 sums in the tensor cores' order) within the
same tolerance of K2, also on docs of 1, 128, 129 and up to 299 rows (not
multiples of its 128-row slab), runs of 1 and 16 pairs, queries of 3, 32,
33 and 130 tokens and a batch whose blocks each walk many runs; two calls
bit-equal; launch counts, ``mma_launches`` for the tensor-core body alone;
the inputs the wrappers refuse; the engine with each on the card against
the CPU.

K10 (flash attention), at head dims 64, 72, 80, 128 and 256: against its
plain version in f32 and bf16, causal and not, per-tile segments with pads,
ColQwen2.5's interleaved window segments, grouped kv heads (8 on 1 at Dh
256, 16 on 2 at Dh 128), T not a multiple of 64, strided q/k/v views, and
rows whose only allowed key is themselves (output = v exactly); the bf16
instances (serving and with lse) issue HMMA (tensor cores), the f32 ones
none; two calls bit-equal; launch counts; ``mha`` on CUDA tensors raises when the kernel
refuses a shape (Dh 96 among them) instead of running the plain version;
small ColSmol-, ColPali- and ColQwen2.5-shaped models on the card against
the CPU, with one K10 launch per attention layer.

B4 and B5 (K10's backward, Dh 64, 72, 80, 128 and 256): against their
plain versions in f32 (1e-4 of each tensor's largest) and bf16 (one output
ulp plus 1e-5 of the largest), causal and not, per-tile segments with pads,
grouped heads (15 on 5, 8 on 1 at Dh 256, 16 on 2 at Dh 128), ColQwen2.5's
window segments at Dh 80, strided views, T not a multiple of 64 (nor of Dh
256's 32-key tiles); bf16 B4 with its head group split over more blocks
(16 on 2 at Dh 128, 8 on 1 at Dh 256, 15 on 5); the bf16 instances issue
HMMA (tensor cores), the f32 ones none; two calls bit-equal; the forward
that saves lse gives the serving output bit for bit; the autograd Function launches the kernels
(never a plain version) on CUDA tensors and matches the CPU at each head
dim; one train step of small ColSmol-, ColPali- and ColQwen2.5-shaped
models on the card against the CPU.

The engine's transfers: ``_dispatch_batch`` of ``two_stage`` batches of 64
and 1024 queries, on the padded and the packed wire, calls no stream
synchronisation (``torch.cuda.set_sync_debug_mode("error")``), and
``transfer_stats`` counts every batch pinned; 8 distinct batches through
``search_embedded_batches(depth=2)`` (``two_stage``, ``three_stage``)
return what each batch alone returns, bit for bit, and batch 0's arrays
are not written by any later batch.

K11 (the routed experts, ``csrc/moe_experts.cu``) at Kimi-VL-A3B's widths
(hidden 2048, expert width 1408, 64 experts, top 6) on a uniform and on a
skewed layout (half the pairs on one expert, four experts with no token):
within two bf16 roundings (2**-7 of the largest output) of its plain version
(the same sorted layout through f32 matmuls on the card), two calls
bit-equal, launches counted; the inputs it refuses. Latent attention through
K10 at head dim 256 (``mha_padded``: q and k of 192, v of 128 zero-padded)
against plain f32 attention at 192 / 128, in K10's bf16 tolerance. A
Kimi-VL model at full widths cut to 1 vision and 2 text layers (a dense and
a routed one) embeds a page batch with no stream synchronisation
(``set_sync_debug_mode("error")``) and no copy from the card in its trace.

Spans (``tracing.py``): under a CUDA-only profiler they record; a span
given the card sets ``device_ms`` (no more than the host span of one that
ends in a synchronise), one given none leaves it None; and they add no
device operation to the trace.
"""

import contextlib
import time

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
from visual_rag_tpu_torch.retrieval import local, plans, wire
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


# -- the pooled stage-1 (pooled_stage1_scores) ------------------------------------------


def _stage1_inputs(dtype, dev, p, d, b, seed=0, dim=DIM):
    """A P-leading store with mask holes, doc 1 whose every row points away
    from query 0 (dots near -1), docs d // 2 and d - 1 with no valid row;
    int8 stores as codes with their row scales."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((p, d, dim)).astype(np.float32)
    vals /= np.linalg.norm(vals, axis=-1, keepdims=True)
    pooled = rng.standard_normal((b, dim)).astype(np.float32)
    pooled /= np.linalg.norm(pooled, axis=-1, keepdims=True)
    vals[:, 1] = -pooled[0]
    mask = rng.random((p, d)) > 0.3
    mask[0, :] = True
    mask[:, [d // 2, d - 1]] = False
    vals, scales = torch.from_numpy(vals), None
    if dtype == torch.int8:
        vals, scales = quantize_rows_int8(vals)
        scales = scales.to(dev)
    return (vals.to(dtype).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(pooled).to(dev), scales)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.int8])
@pytest.mark.parametrize("b,d,p", [(1, 13, 1), (3, 1000, 10), (64, 13, 76), (1030, 1000, 32)])
def test_pooled_stage1_matches_plain_and_is_deterministic(dev, dtype, b, d, p):
    """The kernel against its plain version: batches of 1 to 1030 (five
    256-query tiles, the last of 6), doc counts that are not a multiple of
    the 32-doc tile, P 1 to 76 with holes; int8 codes with their scales.
    Docs with no valid row score exactly 0; doc 1's negative dots give its
    largest one for query 0; two calls are bit-equal."""
    vals, mask, pooled, scales = _stage1_inputs(dtype, dev, p, d, b)
    before = pt.pooled_stage1_scores.launches
    got, again = (pt.pooled_stage1_scores(vals, mask, pooled, scales) for _ in range(2))
    want = pt.pooled_stage1_scores_ref(vals, mask, pooled, scales)
    torch.cuda.synchronize()
    atol = INT8_ATOL if dtype == torch.int8 else ATOL[dtype]
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    assert torch.equal(got, again)
    assert (got[:, ~mask.any(dim=0)] == 0).all()
    assert float(got[0, 1]) < -0.5 and abs(float(got[0, 1] - want[0, 1])) <= atol
    assert pt.pooled_stage1_scores.launches == before + 2


def test_pooled_stage1_f32_store_keeps_the_matmul(dev):
    """An f32 store takes the plain f32 loop (the tensor cores would need
    TF32): no launch; the kernel's wrapper refuses it."""
    vals, mask, pooled, _ = _stage1_inputs(torch.float32, dev, 4, 100, 8)
    before = pt.pooled_stage1_scores.launches
    got = local.local_pooled_padded({"vals_t": vals, "mask_t": mask}, pooled)
    assert pt.pooled_stage1_scores.launches == before
    assert torch.equal(got, pt.pooled_stage1_scores_ref(vals, mask, pooled))
    with pytest.raises(ValueError, match="float32"):
        pt.pooled_stage1_scores(vals, mask, pooled)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.int8])
def test_pooled_stage1_dim72_store_launches_k6(dev, dtype):
    """A store of rows other than the tensor-core kernel's 128 wide (72
    here) runs on the card instead of raising: the wrapper launches K6 with
    each pooled query as a one-row query of weight 1, the same function on
    the CUDA cores, through the wrapper and through the engine's stage-1;
    within the kernel's tolerance of the plain version, empty docs 0, two
    calls bit-equal."""
    vals, mask, pooled, scales = _stage1_inputs(dtype, dev, 4, 100, 8, dim=72)
    before = (pt.pooled_stage1_scores.launches, pt.pooled_maxsim_scores_qbatch.launches)
    got = pt.pooled_stage1_scores(vals, mask, pooled, scales)
    again = local.local_pooled_padded({"vals_t": vals, "mask_t": mask, "scales_t": scales},
                                      pooled)
    want = pt.pooled_stage1_scores_ref(vals, mask, pooled, scales)
    torch.cuda.synchronize()
    atol = INT8_ATOL if dtype == torch.int8 else ATOL[dtype]
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    assert torch.equal(got, again)
    assert (got[:, ~mask.any(dim=0)] == 0).all()
    assert (pt.pooled_stage1_scores.launches, pt.pooled_maxsim_scores_qbatch.launches) == (
        before[0], before[1] + 2)


@pytest.mark.parametrize("storage_dtype", ["bfloat16", "float16", "int8"])
def test_pooled_stage1_routes_through_the_kernel(dev, monkeypatch, storage_dtype):
    """``two_stage`` with both pooled stage-1 modes and the alias, and
    ``single_pooled`` and ``single_experimental_pooled``, batched and one query
    through ``search_embedded``, launch the kernel and return the ids and
    scores of the plain loop on the same card; ``three_stage`` does not
    launch it."""
    idx = synthetic_index(150, min_tokens=20, max_tokens=300, pooled_rows=6,
                          storage_dtype=storage_dtype, seed=7, device="cpu").to(dev)
    qs = _queries(np.random.default_rng(9), 40, 8, 24)
    eng = RetrievalEngine(idx)
    cuts = dict(top_k=10, prefetch_k=40, stage1_k=60, stage2_k=30, with_payload=False)
    runs = [dict(mode="two_stage", stage1_mode=m) for m in (
        "pooled_query_vs_standard_pooling", "pooled_query_vs_experimental_pooling",
        "pooled_query_vs_tiles")] + [dict(mode="single_pooled"),
                                     dict(mode="single_experimental_pooled")]
    atol = INT8_ATOL if storage_dtype == "int8" else ATOL[torch.bfloat16]
    for kw in runs:
        key = "score" if kw["mode"].startswith("single_") else "score_final"
        before = pt.pooled_stage1_scores.launches
        got = eng.search_embedded_batch(qs, **kw, **cuts) + [eng.search_embedded(qs[0], **kw,
                                                                                  **cuts)]
        assert pt.pooled_stage1_scores.launches == before + 2, kw
        with monkeypatch.context() as m:
            m.setattr(local, "pooled_stage1_scores", pt.pooled_stage1_scores_ref)
            want = eng.search_embedded_batch(qs, **kw, **cuts) + [
                eng.search_embedded(qs[0], **kw, **cuts)]
        for a, c in zip(got, want):
            assert strict_rank_equal([dict(h, score=h[key]) for h in c], a, score_tol=atol), kw
    before = pt.pooled_stage1_scores.launches
    eng.search_embedded_batch(qs, mode="three_stage", **cuts)
    assert pt.pooled_stage1_scores.launches == before


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


# -- the engine's transfers -------------------------------------------------------

RESULT_ARRAYS = ("ids", "scores", "valid", "indices")


def _bf16_engine(dev, query_wire="auto"):
    idx = synthetic_index(300, min_tokens=20, max_tokens=300, pooled_rows=6,
                          storage_dtype="bfloat16", seed=9, device=dev)
    return RetrievalEngine(idx, query_wire=query_wire)


@pytest.mark.parametrize("query_wire", ["padded", "packed"])
def test_dispatch_never_synchronises(dev, query_wire):
    eng = _bf16_engine(dev, query_wire)
    rng = np.random.default_rng(10)
    batches = [_queries(rng, b, 12, 32) for b in (64, 1024)]
    kw = dict(mode="two_stage", top_k=10, prefetch_k=200, with_payload=False,
              return_arrays=True)
    for qb in batches:  # builds the kernels
        eng.search_embedded_batch(qb, **kw)
    pend = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for qb in batches + batches:
            pend.append(eng._dispatch_batch(qb, **kw))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for p, qb in zip(pend, batches + batches):
        res = eng._finish_batch(p)
        assert len(res) == len(qb) and res.valid.all()
    assert eng.transfer_stats == {"batches": 6, "pinned": 6}


@pytest.mark.parametrize("mode", ["two_stage", "three_stage"])
def test_pipeline_on_card_matches_single_batches(dev, mode):
    eng = _bf16_engine(dev)
    rng = np.random.default_rng(11)
    batches = [_queries(rng, b, 8, 32) for b in (64, 1024) * 4]  # 8 distinct batches
    kw = dict(mode=mode, top_k=10, prefetch_k=100, stage1_k=200, stage2_k=100,
              with_payload=False, return_arrays=True)
    kept, piped = None, []
    for res in eng.search_embedded_batches(batches, depth=2, **kw):
        if not piped:  # batch 0 as it was yielded
            kept = {k: getattr(res, k).copy() for k in ("ids", "scores", "indices")}
        piped.append(res)
    for got, qb in zip(piped, batches):
        want = eng.search_embedded_batch(qb, **kw)
        for k in RESULT_ARRAYS:
            assert np.array_equal(getattr(got, k), getattr(want, k)), (k, len(qb))
    for k, v in kept.items():  # nothing later wrote into batch 0's arrays
        assert np.array_equal(v, getattr(piped[0], k)), k
    assert eng.transfer_stats == {"batches": 16, "pinned": 16}


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
        before = (rerank_candidates_dedup.launches, rerank_candidates_sweep.launches,
                  rerank_candidates_dedup.mma_launches)
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
        # K4 has K2's row dots, maxima and fold: the same bits
        assert torch.equal(k4, k2), float((k4 - k2).abs().max())
        if dtype == torch.float32:  # K3's CUDA-core body, the same bits as K2
            assert torch.equal(k3, k2), float((k3 - k2).abs().max())
        else:  # the tensor-core body: the same products, sums in another order
            torch.testing.assert_close(k3, k2, rtol=0, atol=atol)
        assert (k3[cand < 0] == -1e30).all() and (k3[:, 0] == -1e30).all()
        mma = 0 if dtype == torch.float32 else 2
        assert (rerank_candidates_dedup.launches, rerank_candidates_sweep.launches,
                rerank_candidates_dedup.mma_launches) == (
            before[0] + 2, before[1] + 2, before[2] + mma)


def _slab_store(dtype, dev, seed, n_docs):
    """A unit-row store whose docs have 1, 128, 129 and 2-299 rows (most not
    a multiple of K3's 128-row slab), one empty, at 32-row aligned offsets;
    int8: per-doc codes and scales."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, 300, n_docs).astype(np.int32)
    lengths[[0, 1, 2, 3]] = 1, 128, 129, 0
    aligned = (lengths + 31) // 32 * 32
    offsets = np.concatenate([[0], np.cumsum(aligned[:-1])]).astype(np.int32)
    flat = rng.standard_normal((int(aligned.sum()) + 320, DIM)).astype(np.float32)
    flat /= np.linalg.norm(flat, axis=1, keepdims=True)
    flat, offs, lens = (torch.from_numpy(x) for x in (flat, offsets, lengths))
    if dtype == torch.int8:
        codes, scales = quantize_per_doc(flat, offs, lens)
        return codes.to(dev), offs.to(dev), lens.to(dev), int(lengths.max()), scales.to(dev)
    return flat.to(dtype).to(dev), offs.to(dev), lens.to(dev), int(lengths.max()), None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.int8])
@pytest.mark.parametrize("nq,b,k,spread", [
    (3, 40, 30, "heavy"),  # runs of 16 pairs
    (32, 64, 25, "uniform"),  # runs of one pair, mostly
    (33, 48, 20, "heavy"),  # three query tiles, runs of 8
    (130, 16, 12, "uniform"),  # nine query tiles, runs of 2
    (32, 1024, 200, "uniform"),  # every block walks many runs
])
def test_dedup_tensor_core_body_on_its_edges(dev, dtype, nq, b, k, spread):
    """K3's tensor-core body on what its design special-cases: docs of 1
    row, of 128 and 129 rows and of 2-299 (slabs cut by the doc's end), an
    empty doc, runs of 1 to 16 pairs, queries of 3, 32, 33 and 130 tokens
    with masked tails, and a batch of 1024 x 200 over 3000 docs, so that
    each block walks many runs through its ring. Within ATOL (INT8_ATOL) of
    its plain version and of K2, NEG_INF where K2 has it, two calls
    bit-equal, one tensor-core launch a call."""
    flat, offs, lens, max_len, scales = _slab_store(dtype, dev, seed=nq + b,
                                                    n_docs=3000 if b >= 1024 else 300)
    rng = np.random.default_rng(b + k)
    tokens = rng.standard_normal((b, nq, DIM)).astype(np.float32)  # exactly nq rows
    tokens = torch.from_numpy(tokens / np.linalg.norm(tokens, axis=-1, keepdims=True)).to(dev)
    valid = rng.integers(1, nq + 1, b)
    valid[0] = nq
    qmask = (np.arange(nq)[None, :] < valid[:, None]).astype(np.float32)
    qmask = torch.from_numpy(qmask).to(dev)
    n_docs = offs.shape[0]
    cand = rng.integers(0, 6 if spread == "heavy" else n_docs, (b, k))
    cand[::5, 1] = -1
    cand[0, :4] = [0, 1, 2, 3]  # 1, 128, 129 and 0 rows
    cand = torch.from_numpy(cand.astype(np.int32)).to(dev)
    args = (flat, offs, lens, tokens, qmask, cand, max_len, scales)
    before = rerank_candidates_dedup.mma_launches
    got, again = rerank_candidates_dedup(*args), rerank_candidates_dedup(*args)
    want, k2 = rerank_candidates_dedup_ref(*args), rerank_candidates(*args)
    torch.cuda.synchronize()
    assert rerank_candidates_dedup.mma_launches == before + 2
    atol = INT8_ATOL if dtype == torch.int8 else ATOL[dtype]
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    torch.testing.assert_close(got, k2, rtol=0, atol=atol)
    assert torch.equal(got, again)
    assert torch.equal(got == -1e30, k2 == -1e30) and (got[0, 3] == -1e30)


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

# (rtol, atol) for each element. Both sides round f32 values of the same inputs to the output
# dtype: in bf16 they may differ by one output ulp, at most 2**-7 of |want|
FA_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-5)}


def _assert_fa_close(got, want, dtype):
    rtol, atol = FA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def _fa_inputs(dev, dtype, b, t, hq, hkv, seed, tile=None, dh=64):
    """q, k, v as strided views of one fused [B, T, Hq + 2 Hkv, Dh] tensor,
    and seg: per-tile segments (tile rows each) or two segments, then pads."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, t, hq + 2 * hkv, dh)).astype(np.float32))
    qkv = qkv.to(dev, dtype)
    q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    seg = np.zeros((b, t), np.int32)
    for i in range(b):
        n = t - int(rng.integers(0, t // 3))  # valid rows, then pads (segment 0)
        seg[i, :n] = (np.arange(n) // tile + 1) if tile else 1 + (np.arange(n) >= n // 2)
    return q, k, v, torch.from_numpy(seg).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,hq,hkv,tile,dh", [
    (256, 4, 4, 64, 64), (200, 6, 2, None, 64), (1100, 3, 1, 96, 64), (37, 2, 2, None, 64),
    # ColPali's vision tower (Dh 72) and Gemma text model (Dh 256, 8 heads on 1 kv head)
    (256, 4, 4, None, 72), (300, 2, 2, 96, 72), (37, 2, 2, None, 72),
    (200, 8, 1, None, 256), (1100, 8, 1, 96, 256), (37, 2, 1, None, 256),
    # ColQwen2.5's vision tower (Dh 80) and Qwen2.5 text model (Dh 128, 16 heads on 2)
    (256, 4, 4, None, 80), (300, 2, 2, 96, 80), (37, 2, 2, None, 80),
    (200, 16, 2, None, 128), (1100, 4, 2, 96, 128), (37, 2, 1, None, 128)])
def test_flash_attention_matches_plain(dev, dtype, causal, t, hq, hkv, tile, dh):
    q, k, v, seg = _fa_inputs(dev, dtype, 2, t, hq, hkv, seed=t + hq, tile=tile, dh=dh)
    before = flash_attention.launches
    got, again = (flash_attention(q, k, v, seg, causal=causal) for _ in range(2))
    want = flash_attention_plain(q, k, v, seg, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (2, t, hq, dh)
    _assert_fa_close(got, want, dtype)
    assert torch.equal(got, again)
    assert flash_attention.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh,hq,hkv", [(64, 4, 2), (72, 4, 2), (80, 4, 4), (128, 16, 2),
                                       (256, 8, 1)])
def test_flash_attention_row_with_only_itself(dev, dtype, causal, dh, hq, hkv):
    """Every row its own segment: softmax over one key, the output is v."""
    q, k, v, _ = _fa_inputs(dev, dtype, 1, 130, hq, hkv, seed=3, dh=dh)
    seg = torch.arange(130, dtype=torch.int32, device=dev)[None]
    got = flash_attention(q, k, v, seg, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(got, v.repeat_interleave(hq // hkv, dim=2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_on_colqwen_window_segments(dev, dtype):
    """The processor's window ids of a 20 x 22 patch page, in its merge-block
    order: each 8 x 8 patch window's patches lie in runs of 16 (12 at the
    right edge) over four block rows; then pads to T 480; 16 heads of 80."""
    from visual_rag_tpu_torch.models.attention import segment_ids
    from visual_rag_tpu_torch.models.processors import ImageProcessor

    page = ImageProcessor(backend="colqwen2.5", image_token_id=1, patch_pixels=12,
                          max_visual_tokens=120).process_images(
        [np.zeros((200, 220, 3), np.float32)])
    assert page.token_infos[0]["grid_h"] == 20 and page.token_infos[0]["grid_w"] == 22
    seg = segment_ids(torch.from_numpy(page.patch_mask), torch.from_numpy(page.window_ids))
    t = seg.shape[1]
    assert t == 480
    q, k, v, _ = _fa_inputs(dev, dtype, 1, t, 16, 16, seed=8, dh=80)
    seg = seg.to(dev)
    got = flash_attention(q, k, v, seg, causal=False)
    want = flash_attention_plain(q, k, v, seg, causal=False)
    torch.cuda.synchronize()
    _assert_fa_close(got, want, dtype)


def test_flash_attention_refuses_other_head_dims_on_cuda(dev, monkeypatch):
    """Dh 96 is not an instance: a CUDA call raises by name and never falls
    back to the plain version."""
    import visual_rag_tpu_torch.ops.kernels.flash_attention as fa

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(fa, "flash_attention_plain", no_plain)
    q, k, v, seg = _fa_inputs(dev, torch.bfloat16, 1, 64, 2, 2, seed=4, dh=96)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match=r"head dims \(64, 72, 80, 128, 256\), got 96"):
        fa.flash_attention(q, k, v, seg, causal=False)
    assert fa.flash_attention.launches == before


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


def test_colpali_shaped_model_on_card_matches_cpu(dev):
    """ColPali's head dims (vision 72, Gemma text 256 on one kv head), Gemma's
    offset norms, GeGLU and embedding scale: every attention runs K10."""
    import dataclasses

    from visual_rag_tpu_torch.models.colvlm import ColVLMConfig
    from visual_rag_tpu_torch.models.convert import build_model, init_params

    tiny = ColVLMConfig.tiny()
    cfg = dataclasses.replace(
        tiny, dtype="float32", proj_bias=True, connector_bias=True, hf_layout="paligemma",
        vision=dataclasses.replace(tiny.vision, hidden=144, heads=2, max_patches=256,
                                   attn_bias=True),
        text=dataclasses.replace(tiny.text, hidden=512, heads=2, kv_heads=1, mlp_hidden=512,
                                 mlp_act="gelu_tanh", rms_offset=True, embed_scale=True,
                                 causal=False))
    sd = init_params(cfg, seed=1, device="cpu")
    sd = {k: v + 0.1 * torch.randn_like(v) if k.endswith(("scale", "bias")) else v
          for k, v in sd.items()}  # move the zero-initialized offsets and biases
    card, cpu = build_model(cfg, sd, dev), build_model(cfg, sd, "cpu")
    rng = np.random.default_rng(3)
    patches = torch.from_numpy(rng.random((2, 256, 48), dtype=np.float32))
    pmask = torch.ones((2, 256), dtype=torch.bool)
    pmask[1, 200:] = False
    ids = torch.full((2, 300), 7, dtype=torch.int32)
    ids[0, :256], ids[1, :200] = cfg.image_token_id, cfg.image_token_id
    amask = torch.zeros((2, 300), dtype=torch.bool)
    amask[0, :260], amask[1, :204] = True, True
    before = flash_attention.launches
    with torch.inference_mode():
        got = card.embed_pages(*(x.to(dev) for x in (ids, amask, patches, pmask)))
        want = cpu.embed_pages(ids, amask, patches, pmask)
        q_ids = torch.from_numpy(rng.integers(4, 400, (2, 24)).astype(np.int32))
        q_mask = torch.arange(24)[None] < torch.tensor([[24], [11]])
        got_q = card.embed_queries(q_ids.to(dev), q_mask.to(dev))
        want_q = cpu.embed_queries(q_ids, q_mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.vision.layers + 2 * cfg.text.layers
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)
    torch.testing.assert_close(got_q.cpu(), want_q, rtol=0, atol=1e-3)


def test_colqwen_shaped_model_on_card_matches_cpu(dev):
    """ColQwen2.5's head dims (vision 80 with window segments and a full
    layer, Qwen2.5 text 128 with M-RoPE), the 2-D rotary and the PatchMerger,
    pages from the processor (two aspect ratios, one padded) and queries:
    every attention runs K10."""
    import dataclasses

    from visual_rag_tpu_torch.models.colvlm import ColVLMConfig
    from visual_rag_tpu_torch.models.convert import build_model, init_params
    from visual_rag_tpu_torch.models.processors import ImageProcessor

    real = ColVLMConfig.colqwen25_v02()
    cfg = dataclasses.replace(
        real, dtype="float32", image_token_id=500,
        vision=dataclasses.replace(real.vision, hidden=160, layers=3, heads=2, mlp_ratio=2.0,
                                   patch_pixels=48, max_patches=1024, full_attn_layers=(1,)),
        text=dataclasses.replace(real.text, hidden=256, layers=2, heads=2, kv_heads=1,
                                 mlp_hidden=512, vocab=512))
    sd = init_params(cfg, seed=1, device="cpu")
    sd = {k: v + 0.1 * torch.randn_like(v) if k.endswith(("scale", "bias")) else v
          for k, v in sd.items()}
    card, cpu = build_model(cfg, sd, dev), build_model(cfg, sd, "cpu")
    rng = np.random.default_rng(4)
    proc = ImageProcessor(backend="colqwen2.5", image_token_id=500, patch_pixels=48, vocab=512,
                          max_visual_tokens=256).process_images(
        [rng.random((200, 520, 3), dtype=np.float32), rng.random((300, 200, 3), dtype=np.float32)])
    page = [torch.from_numpy(x) for x in (proc.input_ids, proc.attn_mask, proc.patches,
                                          proc.patch_mask, proc.window_ids, proc.patch_positions)]
    before = flash_attention.launches
    with torch.inference_mode():
        got = card.embed_pages(*(x.to(dev) for x in page))
        want = cpu.embed_pages(*page)
        q_ids = torch.from_numpy(rng.integers(4, 400, (2, 24)).astype(np.int32))
        q_mask = torch.arange(24)[None] < torch.tensor([[24], [11]])
        got_q = card.embed_queries(q_ids.to(dev), q_mask.to(dev))
        want_q = cpu.embed_queries(q_ids, q_mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.vision.layers + 2 * cfg.text.layers
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)
    torch.testing.assert_close(got_q.cpu(), want_q, rtol=0, atol=1e-3)


# -- B4 and B5: K10's backward ----------------------------------------------------------

# (rtol, atol as a share of the tensor's largest |want|), each element: f32 sums of the same
# products in another order; bf16 one output ulp (both round f32 values of the same inputs)
BWD_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-5)}


def _assert_bwd_close(got, want, dtype):
    rtol, atol = BWD_TOL[dtype]
    w = want.float()
    assert ((got.float() - w).abs() <= atol * w.abs().max() + rtol * w.abs()).all()


def _bwd(dev, q, k, v, seg, do, causal):
    from visual_rag_tpu_torch.ops.kernels import flash_attention as fa

    out, lse = fa.flash_attention_fwd(q, k, v, seg, causal=causal)
    di = fa.attention_di(out, do)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, do, lse, di, causal=causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, seg, do, lse, di, causal=causal)
    plain = (fa.flash_attention_bwd_dq_plain(q, k, v, seg, do, lse, di, causal=causal),
             *fa.flash_attention_bwd_dkv_plain(q, k, v, seg, do, lse, di, causal=causal))
    return (dq, dk, dv), plain, (out, lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,hq,hkv,tile,dh", [
    (256, 4, 4, 64, 64), (200, 6, 2, None, 64), (1100, 3, 1, 96, 64), (37, 2, 2, None, 64),
    (130, 15, 5, None, 64),
    # ColPali's vision tower (Dh 72, 16 heads) and Gemma text model (Dh 256, 8 on 1)
    (256, 4, 4, None, 72), (300, 16, 16, 96, 72), (37, 2, 2, None, 72),
    (200, 8, 1, None, 256), (1100, 8, 1, 96, 256), (45, 2, 1, None, 256)])
def test_flash_attention_backward_matches_plain(dev, dtype, causal, t, hq, hkv, tile, dh):
    """B4 and B5 (strided q, k, v views; grouped heads up to ColSmol's 15 on
    5 and Gemma's 8 on 1; T not a multiple of 64; pads) against their plain
    versions, two calls bit-equal, one launch each; the forward that saves
    lse gives the serving forward's output bit for bit."""
    from visual_rag_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, seg = _fa_inputs(dev, dtype, 2, t, hq, hkv, seed=t + hq + 7, tile=tile, dh=dh)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(t)).to(dev, dtype)
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
    before = [f.launches for f in counters]
    got, want, (out, lse) = _bwd(dev, q, k, v, seg, do, causal)
    again, _, _ = _bwd(dev, q, k, v, seg, do, causal)
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == [b + 2 for b in before]
    for g, w, a in zip(got, want, again):
        assert g.dtype == dtype and g.shape == w.shape
        _assert_bwd_close(g, w, dtype)
        assert torch.equal(g, a)
    assert torch.equal(out, fa.flash_attention(q, k, v, seg, causal=causal))
    _, lse_plain = fa.flash_attention_fwd_plain(q, k, v, seg, causal=causal)
    torch.testing.assert_close(lse, lse_plain, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,t,hq,hkv,dh,causal", [
    (4, 1024, 16, 2, 128, True), (4, 1088, 8, 1, 256, False), (4, 300, 15, 5, 64, True)])
def test_flash_attention_backward_split_group_matches_plain(dev, b, t, hq, hkv, dh, causal):
    """bf16 B4 at grouped shapes where it splits each kv head's group over
    more blocks (ColQwen2.5's page text, 16 on 2 at Dh 128; ColPali's, 8 on 1
    at Dh 256; ColSmol's 15 on 5): the scratch holds the slices' partial sums
    and the reduction adds them. B4 and B5 within ``BWD_TOL`` of their plain
    versions, two calls bit-equal, one launch each."""
    from visual_rag_tpu_torch.ops.kernels import _build
    from visual_rag_tpu_torch.ops.kernels import flash_attention as fa

    dtype = torch.bfloat16
    ranges = (b * -(-t // 32) * 8 + 255) // 256 * 256  # the range table, 256-byte aligned
    scratch = _build.load_library().vrt_flash_attention_bwd_dkv_scratch(
        dev.index, 1, b, t, hq, hkv, dh)
    assert scratch > ranges  # the group is split: partial dK and dV follow the range table
    q, k, v, seg = _fa_inputs(dev, dtype, b, t, hq, hkv, seed=t + dh, dh=dh)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(t)).to(dev, dtype)
    before = fa.flash_attention_bwd_dkv.launches
    got, want, _ = _bwd(dev, q, k, v, seg, do, causal)
    again, _, _ = _bwd(dev, q, k, v, seg, do, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_dkv.launches == before + 2
    for g, w, a in zip(got, want, again):
        _assert_bwd_close(g, w, dtype)
        assert torch.equal(g, a)


def test_flash_attention_bwd_bf16_instances_use_tensor_cores(dev):
    """The built library's SASS: every bf16 instance of K10's serving forward,
    its forward that saves lse, B4 and B5 (five head dims each) issues HMMA
    (mma.sync on the tensor cores); the f32 instances issue none."""
    from visual_rag_tpu_torch.ops.kernels import _build
    from visual_rag_tpu_torch.tools.sass_diff import library_sass

    _build.load_library()
    sass = library_sass(_build.library_path())
    bf16 = {n: c for n, c in sass.items() if "_mma_kernel" in n}
    f32 = {n: c for n, c in sass.items() if any(k in n for k in (
        "flash_fwd_kernel", "flash_fwd_lse_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"))}
    assert len(bf16) == 20 and len(f32) == 20, (sorted(bf16), sorted(f32))
    assert all(any("HMMA" in x for x in code) for code in bf16.values())
    assert not any("HMMA" in x for code in f32.values() for x in code)


@pytest.mark.parametrize("dtype", [torch.float32])
@pytest.mark.parametrize("dh,hq,hkv", [(64, 6, 2), (72, 4, 4), (80, 4, 4), (128, 16, 2),
                                       (256, 8, 1)])
def test_autograd_function_on_card_matches_cpu(dev, dtype, dh, hq, hkv):
    """The Function's forward and backward (K10 with lse, B4, B5) against the
    same autograd on the CPU (the plain versions), in f32: in bf16 the two
    forwards may round o an ulp apart, which di carries into every gradient
    (the kernels alone are held in bf16 above, on the same o and lse)."""
    q, k, v, seg = _fa_inputs(dev, dtype, 2, 300, hq, hkv, seed=5, tile=100, dh=dh)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(dev, dtype)
    grads = []
    for d in (dev, torch.device("cpu")):
        xs = [x.detach().to(d).clone().requires_grad_() for x in (q, k, v)]
        flash_attention(*xs, seg.to(d), causal=True).backward(do.to(d))
        grads.append([x.grad for x in xs])
    torch.cuda.synchronize()
    for g, w in zip(*grads):
        _assert_bwd_close(g.cpu(), w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,t,hq,hkv,causal,window", [
    (80, 480, 16, 16, False, True), (80, 300, 2, 2, False, False),
    (128, 200, 16, 2, True, False), (128, 1100, 4, 2, True, False)])
def test_backward_at_colqwens_head_dims_matches_plain(dev, monkeypatch, dtype, dh, t, hq, hkv,
                                                       causal, window):
    """B4, B5 and the lse forward at ColQwen2.5's head dims on CUDA tensors:
    Dh 80 over the processor's window segments of a 20 x 22 patch page (pads
    to T 480, 16 heads) and over two segments with pads at T 300; Dh 128 with
    16 heads on 2, causal, at T 200 and 1100 (neither a multiple of 64). The
    kernels launch (no plain version runs for a CUDA tensor inside the
    Function), match their plain versions, and the Function's gradients equal
    the direct calls'."""
    import visual_rag_tpu_torch.ops.kernels.flash_attention as fa
    from visual_rag_tpu_torch.models.attention import segment_ids
    from visual_rag_tpu_torch.models.processors import ImageProcessor

    q, k, v, seg = _fa_inputs(dev, dtype, 2, t, hq, hkv, seed=t + dh, dh=dh)
    if window:
        page = ImageProcessor(backend="colqwen2.5", image_token_id=1, patch_pixels=12,
                              max_visual_tokens=120).process_images(
            [np.zeros((200, 220, 3), np.float32)])
        seg = segment_ids(torch.from_numpy(page.patch_mask),
                          torch.from_numpy(page.window_ids)).to(dev).repeat(2, 1)
        assert seg.shape == (2, t) and int(seg.max()) == 9
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(dh)).to(dev, dtype)
    got, want, (out, lse) = _bwd(dev, q, k, v, seg, do, causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _assert_bwd_close(g, w, dtype)
    _, lse_plain = fa.flash_attention_fwd_plain(q, k, v, seg, causal=causal)
    torch.testing.assert_close(lse, lse_plain, rtol=0, atol=1e-5)
    assert torch.equal(out, fa.flash_attention(q, k, v, seg, causal=causal))

    def no_plain(*a, **kw):
        raise AssertionError("a plain version ran for a CUDA tensor")

    for name in ("flash_attention_bwd_dkv_plain", "flash_attention_bwd_dq_plain",
                 "flash_attention_fwd_plain"):
        monkeypatch.setattr(fa, name, no_plain)
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
    before = [f.launches for f in counters]
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*xs, seg, causal=causal).backward(do)
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == [b + 1 for b in before]
    for x, g in zip(xs, got):
        assert torch.equal(x.grad, g)


def _train_step_card_vs_cpu(dev, cfg, batch, remat_on_card=False):
    """One train step's loss and every gradient in f32 on the card (with
    ``remat`` there if asked) against the CPU, from the same seeded weights;
    K10 with lse, B4 and B5 launch once per attention layer (the lse forward
    twice under remat) and the serving forward never."""
    import dataclasses

    from visual_rag_tpu_torch.models.convert import init_params
    from visual_rag_tpu_torch.models.train import Trainer
    from visual_rag_tpu_torch.ops.kernels import flash_attention as fa

    sd = init_params(cfg, seed=2, device="cpu", param_dtype=torch.float32)
    out = {}
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq,
                fa.flash_attention)
    before = [f.launches for f in counters]
    for d, remat in ((dev, remat_on_card), ("cpu", False)):
        trainer = Trainer(dataclasses.replace(cfg, remat=remat), lr=1e-4, warmup=0, device=d)
        (loss, _), grads = trainer.value_and_grad(trainer.init_state(params=sd).params, batch)
        out[str(d)] = (float(loss), {k: g.cpu() for k, g in grads.items()})
    torch.cuda.synchronize()
    layers = cfg.vision.layers + 2 * cfg.text.layers
    want = [(2 if remat_on_card else 1) * layers, layers, layers, 0]
    assert [f.launches for f in counters] == [b + n for b, n in zip(before, want)]
    (l_card, g_card), (l_cpu, g_cpu) = out[str(dev)], out["cpu"]
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    for k, w in g_cpu.items():
        assert (g_card[k] - w).abs().max() <= 1e-3 * w.abs().max() + 1e-6, k


def test_train_step_on_card_matches_cpu(dev):
    """A ColSmol-shaped model (Dh 64 in both towers, pixel shuffle 2, per-tile
    window ids, a padded page) in f32: the loss and every gradient of one
    train step on the card against the CPU; K10, B4 and B5 launch once per
    attention layer and pass."""
    import dataclasses

    from visual_rag_tpu_torch.models.colvlm import ColVLMConfig

    tiny = ColVLMConfig.tiny()
    cfg = dataclasses.replace(
        tiny, dtype="float32", proj_bias=True, connector_bias=False,
        vision=dataclasses.replace(tiny.vision, hidden=128, heads=2, pixel_shuffle=2,
                                   max_patches=2048, attn_bias=True),
        text=dataclasses.replace(tiny.text, hidden=128, heads=2, kv_heads=1))
    rng = np.random.default_rng(3)
    n = 2 * 256
    pmask = np.ones((3, n), bool)
    pmask[2, 256:] = False
    wids = np.repeat(np.arange(2, dtype=np.int32), 256)[None].repeat(3, 0)
    wids[2, 256:] = -1
    ids = rng.integers(4, 500, (3, 136)).astype(np.int32)
    ids[:2, :128], ids[2, :64] = cfg.image_token_id, cfg.image_token_id
    amask = np.ones((3, 136), bool)
    amask[2, 70:] = False
    batch = {"query_ids": rng.integers(4, 500, (3, 11)).astype(np.int32),
             "query_mask": np.arange(11)[None] < np.array([[11], [7], [9]]),
             "page_ids": ids, "page_mask": amask,
             "patches": rng.random((3, n, 48), dtype=np.float32), "patch_mask": pmask,
             "window_ids": wids}
    _train_step_card_vs_cpu(dev, cfg, batch)


def test_colpali_train_step_on_card_matches_cpu(dev):
    """A ColPali-shaped model (SigLIP 144 wide on 2 heads of 72 with attention
    biases; Gemma 512 wide on 2 query heads of 256 and one kv head,
    bidirectional, offset RMSNorm, GeGLU, the embedding scale; 256-patch
    pages, one padded) in f32, with ``remat`` on the card: as above, at Dh
    72 and 256."""
    import dataclasses

    from visual_rag_tpu_torch.models.colvlm import ColVLMConfig

    tiny = ColVLMConfig.tiny()
    cfg = dataclasses.replace(
        tiny, dtype="float32", proj_bias=True, connector_bias=True, hf_layout="paligemma",
        vision=dataclasses.replace(tiny.vision, hidden=144, heads=2, max_patches=256,
                                   attn_bias=True),
        text=dataclasses.replace(tiny.text, hidden=512, heads=2, kv_heads=1, mlp_hidden=1024,
                                 rope_theta=10000.0, mlp_act="gelu_tanh", rms_offset=True,
                                 embed_scale=True, causal=False, max_seq=512))
    rng = np.random.default_rng(3)
    pmask = np.ones((3, 256), bool)
    pmask[2, 200:] = False
    ids = rng.integers(4, 480, (3, 264)).astype(np.int32)
    ids[:2, :256], ids[2, :200] = cfg.image_token_id, cfg.image_token_id
    amask = np.ones((3, 264), bool)
    amask[2, 204:] = False
    batch = {"query_ids": rng.integers(4, 480, (3, 11)).astype(np.int32),
             "query_mask": np.arange(11)[None] < np.array([[11], [7], [9]]),
             "page_ids": ids, "page_mask": amask,
             "patches": rng.random((3, 256, 48), dtype=np.float32), "patch_mask": pmask}
    _train_step_card_vs_cpu(dev, cfg, batch, remat_on_card=True)


def test_colqwen_train_step_on_card_matches_cpu(dev):
    """A ColQwen-shaped model (vision 160 wide on 2 heads of 80 with window
    segments and one full layer between window layers; Qwen2.5 text 256 wide
    on 2 heads of 128 and one kv head, causal, M-RoPE; 256-patch pages from
    the processor, two of three padded, window ids; the patch positions left
    out, as the trainer drops them) in f32, with ``remat`` on the card: as
    above, at Dh 80 and 128."""
    import dataclasses

    from visual_rag_tpu_torch.models.colvlm import ColVLMConfig
    from visual_rag_tpu_torch.models.processors import ImageProcessor

    real = ColVLMConfig.colqwen25_v02()
    cfg = dataclasses.replace(
        real, dtype="float32", image_token_id=500,
        vision=dataclasses.replace(real.vision, hidden=160, layers=3, heads=2, mlp_ratio=2.0,
                                   patch_pixels=48, max_patches=256, full_attn_layers=(1,)),
        text=dataclasses.replace(real.text, hidden=256, layers=2, heads=2, kv_heads=1,
                                 mlp_hidden=512, vocab=512, max_seq=512))
    rng = np.random.default_rng(3)
    proc = ImageProcessor(backend="colqwen2.5", image_token_id=500, patch_pixels=48, vocab=512,
                          max_visual_tokens=64)
    pages = proc.process_images([rng.random(hw + (3,), dtype=np.float32)
                                 for hw in ((200, 520), (300, 200), (120, 120))])
    q_ids, q_mask = proc.process_queries(["what is the revenue of the third quarter",
                                          "a chart of annual growth", "cost"])
    batch = {"query_ids": q_ids, "query_mask": q_mask, "page_ids": pages.input_ids,
             "page_mask": pages.attn_mask, "patches": pages.patches,
             "patch_mask": pages.patch_mask, "window_ids": pages.window_ids}
    _train_step_card_vs_cpu(dev, cfg, batch, remat_on_card=True)


def test_spans_time_the_device_and_add_no_device_operation(dev):
    """Under a CUDA-only profiler (the benchmark's traced windows) spans
    record; ``device_ms`` of a span given the card is the stream's time
    between its two events, no more than the host span of one that ends in
    a synchronise; a span given no device has none; and a window with spans
    holds the same device operations as one without."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from visual_rag_tpu_torch import tracing

    a = torch.randn(4096, 4096, device=dev) / 64
    a @ a  # cuBLAS set up outside the windows

    def window(with_spans):
        def sp(name, **kw):
            return tracing.span(name, **kw) if with_spans else contextlib.nullcontext()

        tracing.clear()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with sp("work", device=a.device):
                b = a
                for _ in range(4):
                    b = b @ a
                torch.cuda.synchronize()
            with sp("enqueue", device=a.device), sp("host"):
                b = b @ a
            torch.cuda.synchronize()
        return sorted(ev.name() for ev in prof.profiler.kineto_results.events()
                      if ev.device_type() == DeviceType.CUDA and ev.duration_ns() > 0)

    plain = window(False)
    assert tracing.spans() == []
    traced = window(True)
    work, host, enqueue = tracing.spans()
    assert traced == plain and len(plain) >= 5
    host_ms = (work.end_ns - work.start_ns) / 1e6
    assert work.device_ms is not None and 0 < work.device_ms <= host_ms
    assert enqueue.device_ms is not None and enqueue.device_ms > 0
    assert host.name == "host" and host.device_ms is None
    tracing.clear()


# K11 against its plain version: h, y and the output are each rounded to bf16 from f32
# sums taken in another order, so they may land an ulp apart; the output's error stays
# within two bf16 roundings of the largest output
MOE_TOL = 2.0 ** -7
KIMI_MOE = (6, 64, 2048, 1408)  # top k, experts, hidden, expert width


@pytest.mark.parametrize("spread", ["uniform", "skewed"])
def test_moe_experts_at_kimi_widths(dev, spread):
    from visual_rag_tpu_torch.ops.kernels import moe_experts as me
    from visual_rag_tpu_torch.tools.emulate_kernels import moe_inputs

    args = moe_inputs(1000, *KIMI_MOE, spread, device=dev)
    if spread == "skewed":
        assert args[4].counts[60:].tolist() == [0] * 4 and int(args[4].counts[0]) == 1000
    before = me.moe_experts.launches
    got, again = me.moe_experts(*args), me.moe_experts(*args)
    want = me.moe_experts_plain(*args)
    torch.cuda.synchronize()
    assert me.moe_experts.launches == before + 2
    assert torch.equal(got, again)
    err = float((got.float() - want.float()).abs().max())
    assert err <= MOE_TOL * float(want.float().abs().max())


def test_moe_experts_refuses_what_it_does_not_take(dev):
    from visual_rag_tpu_torch.ops.kernels import moe_experts as me
    from visual_rag_tpu_torch.tools.emulate_kernels import moe_inputs

    x, gate, up, down, lay, w, base = moe_inputs(10, 2, 4, 256, 128, "uniform", device=dev)
    with pytest.raises(ValueError, match="bf16"):
        me.moe_experts(x.float(), gate, up, down, lay, w, base)
    with pytest.raises(ValueError, match="f32"):
        me.moe_experts(x, gate, up, down, lay, w.double(), base)
    narrow = [a[:, :96].contiguous() for a in (gate, up)]  # an expert width of 96
    with pytest.raises(ValueError, match="multiple"):
        me.moe_experts(x, *narrow, down[..., :96].contiguous(), lay, w, base)
    launches = me.moe_experts.launches
    me.moe_experts(x, gate, up, down, lay, w, base)
    assert me.moe_experts.launches == launches + 1


def test_latent_attention_through_k10_at_dh256(dev):
    from visual_rag_tpu_torch.models.attention import mha_padded
    from visual_rag_tpu_torch.ops.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=dev).manual_seed(21)
    b, t, h = 2, 300, 16
    q, k = (torch.randn(b, t, h, 192, generator=gen, device=dev).bfloat16() for _ in range(2))
    v = torch.randn(b, t, h, 128, generator=gen, device=dev).bfloat16()
    mask = torch.arange(t, device=dev)[None] < torch.tensor([[300], [211]], device=dev)
    before = flash_attention.launches
    got = mha_padded(q, k, v, mask, causal=True, dtype=torch.bfloat16, to=256)
    assert flash_attention.launches == before + 1 and got.shape == (b, t, h, 128)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 192 ** -0.5
    ok = torch.ones(t, t, dtype=torch.bool, device=dev).tril() & mask[:, None, None, :]
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits.masked_fill(~ok, -1e30), -1),
                        v.float())
    rows = mask[..., None, None].expand_as(got)
    _assert_fa_close(got.float()[rows], want[rows], torch.bfloat16)


def test_kimi_forward_never_synchronises(dev):
    """A page batch through a full-width Kimi-VL cut to 1 vision and 2 text
    layers: no synchronising call (the sync debug mode raises on one) and
    no copy from the card or stream synchronise in the profiler's trace."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from visual_rag_tpu_torch.models.colvlm import ColVLMConfig, RoutedMoE
    from visual_rag_tpu_torch.models.embedder import VisualEmbedder

    base = ColVLMConfig.kimi_vl_a3b()
    cfg = dataclasses.replace(base, vision=dataclasses.replace(base.vision, layers=1),
                              text=dataclasses.replace(base.text, layers=2))
    emb = VisualEmbedder("moonshotai/Kimi-VL-A3B-Instruct", config=cfg, device=dev)
    rng = np.random.default_rng(3)
    proc = emb.processor.process_images(
        [rng.integers(0, 256, (877, 620, 3), dtype=np.uint8) for _ in range(2)])
    host = [proc.input_ids, proc.attn_mask, proc.patches.astype(np.float16), proc.patch_mask,
            proc.patch_positions]
    ids, am, patches, pm, pos = (torch.from_numpy(a).to(dev) for a in host)
    grids = [(i["grid_h"], i["grid_w"]) for i in proc.token_infos]
    model = emb.model
    with torch.inference_mode():
        model.embed_pages(ids, am, patches, pm, None, pos, grids)  # warm: cuBLAS, the library
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.time_ns()  # the profiler's clock
                out = model.embed_pages(ids, am, patches, pm, None, pos, grids)
                t1 = time.time_ns()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    assert not [e.name() for e in events if "DtoH" in e.name()]
    assert not [e.name() for e in events
                if "Synchronize" in e.name() and t0 <= e.start_ns() <= t1]
    assert torch.isfinite(out).all() and out.shape[:2] == ids.shape
    moe = [m for m in model.modules() if isinstance(m, RoutedMoE)]
    assert len(moe) == 1 and int(moe[0].stats["tokens"].sum()) == 2 * ids.numel() * 6
