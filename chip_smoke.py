"""Drive the PyTorch/CUDA port's query and embedding paths once on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, in order; any failure raises and the script exits non-zero:

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, then the kernels built from ``visual_rag_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes on the 3k-doc bf16 corpus (rerank: 32 queries x 200
   candidates with some -1; scan: 64 packed queries x every doc; tokens
   stage-1: 64 packed queries (K5) and 16 padded queries (K6, K7) x the
   P = 10 pooled store, and again x a P = 76 store with mask holes and two
   docs with no valid row), within atol 1e-3, two calls bit-equal; then the
   engine on a small f32 corpus with all four stores and payloads, on the
   card against the same index on the CPU, in every search mode, every
   stage-1 mode and with a filter.
3. The main path: ``two_stage`` (prefetch_k=200, top_k=10) through
   ``search_embedded_batches`` at bs 32, 256 and 1024 on the 3k corpus.
4. The strict oracle at 3k on 256 queries at score tolerance 0.
5. 100k docs: ``two_stage`` at bs 1024 (K3, the dedup rerank, by the JAX
   engine's policy), ``single_full`` at bs 256 and the strict oracle on 64
   queries.
6. Serving: the port's SearchServer answers 8 concurrent POST /search with
   the ids a direct ``search_embedded_batch`` gives.
7. Launch counts of K2, K3 and the scan over phases 3-6; each must be > 0.
8. The tokens stage-1 path (``stage1_mode="tokens_vs_standard_pooling"``),
   with the counts set to 0 first: K5 once against its plain version at
   the 100k bs 1024 shape (before the reset), then ``two_stage`` at 3k bs 16
   (padded wire: K6) and bs 256 (packed: K5) and at 100k bs 1024,
   ``three_stage`` at 100k bs 1024, ``single_tiles`` at 3k bs 256, a
   filtered ``two_stage`` at 3k (every hit satisfies the filter), 16
   per-query ``search_embedded`` calls (K7) that agree with the batch, and
   the strict oracle of the new stage-1 (``prefetch_k`` = corpus against
   ``single_full``, tolerance 0). K5, K6 and K7 must each have launched.
9. int8 storage. The 3k corpus is quantized once on the CPU
   (``quantize_index``) to ``int8`` and ``int8_refined`` and moved to the
   card. First, not counted: the int8 bodies (bf16 queries) of K2, K1, K5,
   K6 and K7 and the qdot bodies (int8 queries, integer dots) of K1 and
   K5/K6/K7 -- K5's is K9's function -- against their plain versions (K2 32
   x 200; K1 64 packed x 3000 docs; K5 64 packed x 3000 docs, P 10, and
   1024 packed x 100k docs, P 12; K6/K7 16 queries; a P = 76 int8 store with
   holes), within ATOL, two calls bit-equal, and with one query row a group
   the qdot scores bit-equal to the plain version's. Then, counts at 0: the
   card against the CPU in every mode, stage-1 mode and a filter (16
   queries, ids); ``two_stage`` QPS at 3k bs 256 (pooled and tokens, both
   dtypes); ``single_tiles`` and the tokens ``two_stage`` at bs 16 and 256;
   per-query ``search_embedded`` (K7); the strict oracles at tolerance 0
   for both dtypes and both stage-1 kinds; the top-10 overlap with the bf16
   engine; at 100k ``int8_refined`` ``two_stage`` bs 1024 (pooled, tokens),
   ``single_full`` bs 256, ``three_stage`` bs 1024, and ``int8`` ``two_stage``
   bs 1024; the token store's bytes per dtype. Every entry point's int8
   count and every qdot count must be > 0.
10. K3 (dedup) and K4 (sweep), the reranks the policy picks for batches of
   64 and more (K4 where the candidates cover the store six times and more).
   First, not counted: each against its plain version (within ATOL, two calls
   bit-equal) and against K2 on the same inputs (the difference is logged;
   they share K2's row dots and fold), with the CUDA-event ms of K2, K3, K4
   and both plain versions, at 32 x 200 and 256 x 200 on the 3k corpus and
   1024 x 200 at 100k, on bf16 and on ``int8`` (the plain versions once at
   100k). Then, counts at 0: at 100k bf16 ``two_stage`` bs 1024 (pooled,
   then tokens stage-1) and ``three_stage`` bs 1024, at 100k
   ``int8_refined`` pooled ``two_stage`` bs 1024 (K3 each, count > 0), and
   on the 3k corpus on the padded wire at bs 256 (K4, count > 0), each with
   its QPS beside the same engine's with ``rerank_impl="plain"`` (K2; two
   runs each, alternating) and ids equal to that engine's;
   the strict oracle on the padded 3k engine (64 queries, ``prefetch_k`` =
   corpus: K4 against ``single_full``'s K1), logged at tolerance 0 and
   required at 1e-4.
11. The ColSmol-500M embedding path. First, not counted: K10 (flash
   attention) against its plain version at the path's shapes -- vision, one
   page of 17 tiles (T 17408, 12 heads, per-tile segments); page text, 4
   pages of 13 tiles (T 896, 15 / 5 heads, causal, pads); 64 queries (T 30,
   causal) -- in bf16 (atol 2e-2) and f32 (atol 1e-4), two calls bit-equal,
   with the CUDA-event ms of K10, of the plain version and of SDPA with the
   same boolean mask; and K10's time on a batch that pads a 5-tile page to
   17 tiles. Then, counts at 0, the main path: full-width ColSmol-500M in
   bf16 with random weights from seed 0 embeds 32 pages (8 each of 5, 9, 13
   and 17 tiles, a batch per geometry) and 64 queries (pages/s, queries/s
   after a warm batch; K10 launched layers x batches times), the pages go
   through ``page_vectors`` and ``IndexBuilder.seal`` (bf16) into the
   engine, which answers ``two_stage`` (prefetch_k 200, top_k 10) with the
   embedded queries at bs 64 and 16 with both stage-1 modes, and the strict
   oracle holds at tolerance 0; K2, the scan and a tokens stage-1 kernel
   must each have launched. Then, not counted: the same weights with
   ``use_flash=False`` (dense attention) on 2 pages and 16 queries, per-token
   cosine >= 0.99; and the full-width model in f32 on the card and on the
   CPU, 4 queries, atol 1e-3.

Every kernel entry carries ``bound_ms`` (the larger of its bytes over 3.35
TB/s and its operations over the peak rate of their type: 989 TFLOP/s bf16,
67 TFLOP/s f32, 1979 TOP/s int8), ``bound_by``, and ``library_ms`` (SDPA for
K10; null for the MaxSim kernels, which no single PyTorch call computes).
The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON summary. Without a CUDA device the script raises at once.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BENCH_KW = dict(mode="two_stage", top_k=10, prefetch_k=200, with_payload=False)
TOKENS = "tokens_vs_standard_pooling"  # the pipeline's own stage-1 (demo/commands.py:47)
ATOL = 1e-3  # bf16 inputs, f32 accumulation in both: only the summation order differs


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0].strip()


def queries(seed: int, n: int):
    """Bench-protocol queries: 8-24 tokens of dim 128 (bench.py:509-513)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(8, 25)), 128)).astype(np.float32)
            for _ in range(n)]


def cuda_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


def bound(nbytes: float, ops: float, peak: str):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate and the operations over the peak rate
    of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[peak]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _nb(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def maxsim_bound(kind: str, args, qdot: bool = False):
    """``bound_ms`` and ``bound_by`` of a MaxSim kernel call on these
    inputs (no single PyTorch call computes MaxSim, so ``library_ms`` is
    null beside it): each input read
    once (the rows of the docs the call scores, the queries, the masks and
    candidates), each output written once; 2 * dim operations per (valid
    query row, scored doc row) pair, at the bf16 rate (f32 for an f32
    store, int8 for the qdot body)."""
    if kind == "rerank":  # flat, offsets, lengths, tokens [B, NQ, dim], qmask, cand [B, K]
        flat, offsets, lengths, tokens, qmask, cand = args[:6]
        valid = cand >= 0
        lens = lengths.long()[cand.long().clamp(min=0)] * valid
        ops = 2 * flat.shape[1] * float(((qmask > 0).sum(1, keepdim=True) * lens).sum())
        rows = int(lengths.long()[cand[valid].long().unique()].sum())
        nbytes = (rows * flat.shape[1] * flat.element_size() + _nb(tokens) + _nb(qmask)
                  + 2 * _nb(cand) + cand.numel() * 4)
    elif kind == "scan":  # flat, offsets, lengths, q [M, dim], qid [M], max_len, B
        flat, offsets, lengths, q, qid = args[:5]
        rows = int(lengths.long().sum())
        ops = 2 * flat.shape[1] * float((qid >= 0).sum()) * rows
        nbytes = (rows * flat.shape[1] * flat.element_size() + _nb(q) + _nb(qid)
                  + int(args[6]) * offsets.shape[0] * 4)
    else:  # pooled: vals_t [P, D, dim], mask_t [P, D], then (q, qid) packed or (tokens, qmask)
        vals, mask, q, qid = args[:4]
        q_rows = float((qid >= 0).sum()) if kind == "pooled_packed" else float((qid > 0).sum())
        n_q = int(args[4]) if kind == "pooled_packed" else q.shape[0]
        ops = 2 * vals.shape[2] * q_rows * float(mask.sum())
        nbytes = _nb(vals) + _nb(mask) + _nb(q) + _nb(qid) + n_q * vals.shape[1] * 4
    import torch

    peak = "int8" if qdot else ("f32" if args[0].dtype == torch.float32 else "bf16")
    ms, by = bound(nbytes, ops, peak)
    return {"bound_ms": ms, "bound_by": by}


def check_results(res, bs: int, what: str):
    if res.scores.shape != (bs, 10) or not res.valid.all():
        raise AssertionError(f"{what}: expected {bs} x 10 valid hits, got {res.scores.shape}")
    if not np.isfinite(res.scores).all():
        raise AssertionError(f"{what}: non-finite scores")


def qps(engine, qs, bs: int, what: str, **kw) -> float:
    import torch

    kw = dict(BENCH_KW, return_arrays=True, **kw)
    batches = [qs[s:s + bs] for s in range(0, len(qs), bs)]
    check_results(engine.search_embedded_batch(batches[0], **kw), bs, what)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for res in engine.search_embedded_batches(batches, **kw):
        check_results(res, bs, what)
    torch.cuda.synchronize()
    return len(qs) / (time.perf_counter() - t0)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    from visual_rag_tpu_torch import RetrievalEngine, synthetic_index
    from visual_rag_tpu_torch.ops.kernels import _build
    from visual_rag_tpu_torch.ops.kernels.maxsim_rerank import (
        rerank_candidates,
        rerank_candidates_dedup,
        rerank_candidates_ref,
    )
    from visual_rag_tpu_torch.ops.kernels.maxsim_scan import (
        exhaustive_scores_packed,
        exhaustive_scores_packed_ref,
    )
    from visual_rag_tpu_torch.ops.kernels.maxsim_sweep import rerank_candidates_sweep
    from visual_rag_tpu_torch.ops.kernels.prefetch_topk import (
        _as_packed,
        pooled_maxsim_scores,
        pooled_maxsim_scores_packed,
        pooled_maxsim_scores_packed_ref,
        pooled_maxsim_scores_qbatch,
    )
    from visual_rag_tpu_torch.retrieval import plans, wire
    from visual_rag_tpu_torch.retrieval.engine import SEARCH_MODES, STAGE1_MODES
    from visual_rag_tpu_torch.retrieval.filters import build_filter
    from visual_rag_tpu_torch.retrieval.local import local_pooled_padded
    from visual_rag_tpu_torch.retrieval.oracle import run_strict_oracle, strict_rank_equal
    from visual_rag_tpu_torch.serving.server import SearchServer

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 1. header and build ------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"kernels: {_build.library_path().name} ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")
    build_log = _build.library_path().with_suffix(".log")
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())

    # -- 2. kernels against their plain versions -----------------------------------
    t0 = time.perf_counter()
    idx3k = synthetic_index(3000, min_tokens=320, max_tokens=832, pooled_rows=10,
                            storage_dtype="bfloat16", seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"3k corpus: {idx3k.store('initial').flat.shape[0]} rows in "
        f"{time.perf_counter() - t0:.2f} s")
    eng3k = RetrievalEngine(idx3k)
    ragged = eng3k._fused_arrays("initial")
    args = (ragged["flat"], ragged["offsets"], ragged["lengths"])
    kernels = []

    raw, qmask = wire.to_device(wire.pad_queries_raw(queries(11, 32), 128), dev)
    tokens, pooled = plans._prep_queries(raw, qmask)
    _, cand = plans._topk_masked(local_pooled_padded(eng3k._fused_arrays("mean_pooling"),
                                                     pooled), 200)
    cand[:, -5:] = -1
    cand[::7, 3] = -1
    rr_args = args + (tokens, qmask, cand, ragged["max_len"])
    got, want = rerank_candidates(*rr_args), rerank_candidates_ref(*rr_args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ms, plain_ms = cuda_ms(lambda: rerank_candidates(*rr_args)), cuda_ms(
        lambda: rerank_candidates_ref(*rr_args), iters=3)
    log(f"rerank_candidates [32 x 200]: max_abs_err {err:.3g} kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms")
    if not torch.allclose(got, want, rtol=0, atol=ATOL):
        raise AssertionError(f"rerank_candidates disagrees with its plain version: {err}")
    kernels.append({"name": "rerank_candidates", "route": "cuda",
                    "source": "visual_rag_tpu_torch/csrc/maxsim_rerank.cu",
                    "replaces": "visual_rag_tpu/ops/kernels/maxsim_rerank.py:163",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                    **maxsim_bound("rerank", rr_args)})

    (p, pos, qid), nq, _ = wire.pack_queries_grouped(queries(12, 64), 128)
    p, pos, qid = wire.to_device((p, pos, qid), dev)
    packed = plans._prep_queries_packed(p, pos, qid, 64, nq)[3]
    sc_args = args + (packed["q"], packed["qid"], ragged["max_len"], 64)
    got, want = exhaustive_scores_packed(*sc_args), exhaustive_scores_packed_ref(*sc_args)
    again = exhaustive_scores_packed(*sc_args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ms, plain_ms = cuda_ms(lambda: exhaustive_scores_packed(*sc_args)), cuda_ms(
        lambda: exhaustive_scores_packed_ref(*sc_args), iters=3)
    log(f"exhaustive_scores_packed [64 x 3000]: max_abs_err {err:.3g} kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms")
    if not torch.allclose(got, want, rtol=0, atol=ATOL):
        raise AssertionError(f"exhaustive_scores_packed disagrees with its plain version: {err}")
    if not torch.equal(got, again):
        raise AssertionError("exhaustive_scores_packed is not deterministic")
    kernels.append({"name": "exhaustive_scores_packed", "route": "cuda",
                    "source": "visual_rag_tpu_torch/csrc/maxsim_scan.cu",
                    "replaces": "visual_rag_tpu/ops/kernels/maxsim_scan.py:240",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                    **maxsim_bound("scan", sc_args)})

    # K5, K6, K7: one kernel behind three entry points, on the 3k pooled store
    # (P = 10) and on a P = 76 store with mask holes and two docs with no row
    def padded_ref(vals, mask, tokens, qmask):
        return pooled_maxsim_scores_packed_ref(vals, mask, *_as_packed(vals, tokens, qmask))

    def hold(name, fn, ref, args):
        got, again, want = fn(*args), fn(*args), ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=0, atol=ATOL):
            raise AssertionError(f"{name} disagrees with its plain version: {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} is not deterministic")
        if not (got[:, ~args[1].any(dim=0)] == 0).all():
            raise AssertionError(f"{name}: a doc with no valid pooled row does not score 0")
        return err

    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    v76 = torch.nn.functional.normalize(
        torch.randn((76, 3000, 128), generator=gen, device=dev), dim=-1).to(torch.bfloat16)
    m76 = torch.rand((76, 3000), generator=gen, device=dev) > 0.3
    m76[:, [17, 2999]] = False
    pooled3k = eng3k._fused_arrays("mean_pooling")
    raw16, qmask16 = wire.to_device(wire.pad_queries_raw(queries(15, 16), 128), dev)
    tokens16, _ = plans._prep_queries(raw16, qmask16)
    stage1 = (
        ("pooled_maxsim_scores_packed", "64 packed queries", pooled_maxsim_scores_packed,
         pooled_maxsim_scores_packed_ref, (packed["q"], packed["qid"], 64, packed["w"]), 212),
        ("pooled_maxsim_scores_qbatch", "16 padded queries", pooled_maxsim_scores_qbatch,
         padded_ref, (tokens16, qmask16), 314),
        ("pooled_maxsim_scores", "16 padded queries", pooled_maxsim_scores, padded_ref,
         (tokens16, qmask16), 358))
    for name, what, fn, ref, qargs, line in stage1:
        args = (pooled3k["vals_t"], pooled3k["mask_t"]) + qargs
        err = max(hold(name, fn, ref, args), hold(name, fn, ref, (v76, m76) + qargs))
        ms = cuda_ms(lambda: fn(*args))
        plain_ms = cuda_ms(lambda: ref(*args), iters=3)
        log(f"{name} [{what} x 3000 docs, P 10; and P 76 with holes]: max_abs_err {err:.3g} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms (P 10)")
        kernels.append({"name": name, "route": "cuda",
                        "source": "visual_rag_tpu_torch/csrc/pooled_maxsim.cu",
                        "replaces": f"visual_rag_tpu/ops/kernels/prefetch_topk.py:{line}",
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                        **maxsim_bound("pooled_packed" if line == 212 else "pooled_padded",
                                       args)})

    # float32: queries normalised on the card and on the CPU differ in the last
    # f32 bit, which a cast to a 2-byte store dtype can turn into a whole ulp
    small = synthetic_index(200, min_tokens=64, max_tokens=300, pooled_rows=10,
                            storage_dtype="float32", seed=4, device="cpu")
    for i, pl in enumerate(small.manifest.payloads):
        pl["year"] = 2020 + i % 4
    qs_small = queries(13, 64)
    cuts = dict(BENCH_KW, prefetch_k=60, stage1_k=100, stage2_k=40)
    runs = [dict(cuts, mode=m) for m in SEARCH_MODES] + [
        dict(cuts, stage1_mode=m) for m in STAGE1_MODES[1:]] + [
        dict(cuts, filter_obj=build_filter(year=[2021, 2023]))]
    for wire_kind in ("padded", "packed"):
        on_card = RetrievalEngine(small.to(dev), query_wire=wire_kind)
        on_cpu = RetrievalEngine(small, query_wire=wire_kind)
        for kw in runs:
            a = on_card.search_embedded_batch(qs_small, **kw)
            b = on_cpu.search_embedded_batch(qs_small, **kw)
            key = "score" if kw["mode"].startswith("single_") else "score_final"
            ok = all(strict_rank_equal([dict(h, score=h[key]) for h in x], y, score_tol=1e-4)
                     for x, y in zip(b, a))
            what = " ".join(str(kw[k]) for k in ("mode", "stage1_mode", "filter_obj") if k in kw)
            if not ok:
                raise AssertionError(f"card and CPU disagree on {wire_kind} {what}")
        log(f"small corpus {wire_kind}: card == cpu plain in {len(runs)} runs "
            f"(8 modes, 4 more stage-1 modes, 1 filter)")

    # -- 3. main path at the bench protocol ----------------------------------------
    for fn in (rerank_candidates, rerank_candidates_dedup, rerank_candidates_sweep,
               exhaustive_scores_packed):
        fn.launches = 0
    qs = queries(1, 2048)
    rungs = {}
    for bs, n in ((32, 512), (256, 2048), (1024, 2048)):
        path = eng3k._rerank_impl(bs, 200, eng3k._use_packed(bs))
        rungs[bs] = qps(eng3k, qs[:n], bs, f"3k bs={bs}")
        log(f"3k two_stage bs={bs} ({path} rerank): {rungs[bs]:.1f} QPS [{card}]")

    # -- 4. strict oracle at 3k ----------------------------------------------------
    ok3k = run_strict_oracle(eng3k, qs[:256], idx3k.num_docs, score_tol=0.0)
    log(f"strict oracle 3k (256 queries, tol 0): {ok3k}")
    if not ok3k:
        raise AssertionError("strict oracle failed at 3k")

    # -- 5. 100k docs --------------------------------------------------------------
    t0 = time.perf_counter()
    idx100k = synthetic_index(100000, min_tokens=128, max_tokens=256, pooled_rows=12,
                              storage_dtype="bfloat16", seed=2, device=dev)
    torch.cuda.synchronize()
    log(f"100k corpus: {idx100k.store('initial').flat.shape[0]} rows in "
        f"{time.perf_counter() - t0:.2f} s")
    eng100k = RetrievalEngine(idx100k)
    path = eng100k._rerank_impl(1024, 200, eng100k._use_packed(1024))
    q100k = qps(eng100k, qs, 1024, "100k bs=1024")
    log(f"100k two_stage bs=1024 ({path} rerank): {q100k:.1f} QPS [{card}]")
    q100k_full = qps(eng100k, qs[:512], 256, "100k single_full", mode="single_full")
    log(f"100k single_full bs=256: {q100k_full:.1f} QPS [{card}]")
    ok100k = run_strict_oracle(eng100k, qs[:64], idx100k.num_docs, score_tol=0.0)
    log(f"strict oracle 100k (64 queries, tol 0): {ok100k}")
    if not ok100k:
        raise AssertionError("strict oracle failed at 100k")

    # -- 6. serving ----------------------------------------------------------------
    served = qs[:8]
    direct = eng3k.search_embedded_batch(served, **BENCH_KW)
    server = SearchServer(eng3k).start()
    answers = [None] * len(served)
    try:
        def post(i):
            body = json.dumps({"embedding": served[i].tolist(), "mode": "two_stage",
                               "top_k": 10, "prefetch_k": 200}).encode()
            req = urllib.request.Request(
                f"http://{server.host}:{server.port}/search", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                answers[i] = json.loads(resp.read())["results"]

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(served))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        server.stop()
    for i, (got_hits, want_hits) in enumerate(zip(answers, direct)):
        if got_hits is None or [h["id"] for h in got_hits] != [h["id"] for h in want_hits]:
            raise AssertionError(f"served query {i} differs from the direct search")
    log(f"serving: {len(served)} concurrent POST /search match direct search "
        f"({server.batcher.stats})")

    # -- 7. launch counts ----------------------------------------------------------
    counts = {"rerank_candidates": rerank_candidates.launches,
              "rerank_candidates_dedup": rerank_candidates_dedup.launches,
              "exhaustive_scores_packed": exhaustive_scores_packed.launches}
    log(f"launches over phases 3-6: {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")

    # -- 8. the tokens stage-1 path --------------------------------------------------
    # K5 against its plain version at the 100k bs 1024 serving shape (not counted)
    (p, pos, qid), nq, _ = wire.pack_queries_grouped(qs[:1024], 128)
    pk100 = plans._prep_queries_packed(*wire.to_device((p, pos, qid), dev), 1024, nq)[3]
    s100 = eng100k._fused_arrays("mean_pooling")
    args = (s100["vals_t"], s100["mask_t"], pk100["q"], pk100["qid"], 1024, pk100["w"])
    got, want = pooled_maxsim_scores_packed(*args), pooled_maxsim_scores_packed_ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ms = cuda_ms(lambda: pooled_maxsim_scores_packed(*args), iters=3)
    plain_ms = cuda_ms(lambda: pooled_maxsim_scores_packed_ref(*args), iters=1)
    log(f"pooled_maxsim_scores_packed [1024 packed queries ({pk100['q'].shape[0]} rows) x "
        f"100000 docs, P 12]: max_abs_err {err:.3g} kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    if not torch.allclose(got, want, rtol=0, atol=ATOL):
        raise AssertionError(f"pooled_maxsim_scores_packed disagrees at 100k: {err}")
    k5 = next(k for k in kernels if k["name"] == "pooled_maxsim_scores_packed")
    k5.update(max_abs_err=max(k5["max_abs_err"], err), ms_100k=ms, plain_ms_100k=plain_ms,
              bound_ms_100k=maxsim_bound("pooled_packed", args)["bound_ms"])
    del got, want

    entry_points = (rerank_candidates, exhaustive_scores_packed, pooled_maxsim_scores_packed,
                    pooled_maxsim_scores_qbatch, pooled_maxsim_scores)
    for fn in entry_points:
        fn.launches = 0
    tok = dict(stage1_mode=TOKENS)
    for bs, n in ((16, 256), (256, 2048)):
        r = qps(eng3k, qs[:n], bs, f"3k tokens bs={bs}", **tok)
        log(f"3k two_stage {TOKENS} bs={bs} ({'packed' if eng3k._use_packed(bs) else 'padded'} "
            f"wire): {r:.1f} QPS [{card}]")
    r = qps(eng100k, qs, 1024, "100k tokens bs=1024", **tok)
    log(f"100k two_stage {TOKENS} bs=1024: {r:.1f} QPS [{card}]")
    r = qps(eng100k, qs, 1024, "100k three_stage", mode="three_stage", stage1_k=1000,
            stage2_k=300)
    log(f"100k three_stage bs=1024 (stage1_k 1000, stage2_k 300): {r:.1f} QPS [{card}]")
    del eng100k, idx100k
    r = qps(eng3k, qs, 256, "3k single_tiles", mode="single_tiles")
    log(f"3k single_tiles bs=256: {r:.1f} QPS [{card}]")

    for i, pl in enumerate(idx3k.manifest.payloads):
        pl["year"] = 2020 + i % 4
    filt = build_filter(year=[2021, 2023])
    hits = eng3k.search_embedded_batch(qs[:512], **dict(BENCH_KW, with_payload=True), **tok,
                                       filter_obj=filt)
    if not all(len(h) == 10 and all(x["payload"]["year"] in (2021, 2023) for x in h)
               for h in hits):
        raise AssertionError("a filtered search returned a hit outside the filter")
    r = qps(eng3k, qs[:2048], 256, "3k filtered", filter_obj=filt, **tok)
    log(f"3k two_stage {TOKENS} filtered year in (2021, 2023) bs=256: every hit satisfies "
        f"the filter; {r:.1f} QPS [{card}]")

    batch = eng3k.search_embedded_batch(qs[:16], **BENCH_KW, **tok)
    for q, want_hits in zip(qs[:16], batch):
        one = eng3k.search_embedded(q, **BENCH_KW, **tok)
        if [h["id"] for h in one] != [h["id"] for h in want_hits]:
            raise AssertionError("per-query search_embedded differs from the batch")
    log("per-query search_embedded (16 queries, padded wire, bs 1): same ids as the batch")

    exact = eng3k.search_embedded_batch(qs[:256], mode="single_full", top_k=10,
                                        with_payload=False)
    wide = eng3k.search_embedded_batch(qs[:256], mode="two_stage", top_k=10,
                                       prefetch_k=idx3k.num_docs, with_payload=False, **tok)
    ok = all(strict_rank_equal(ex, wd, score_tol=0.0) for ex, wd in zip(exact, wide))
    log(f"strict oracle 3k {TOKENS} (256 queries, prefetch_k = corpus, tol 0): {ok}")
    if not ok:
        raise AssertionError("strict oracle failed for the tokens stage-1")

    counts8 = {fn.__name__: fn.launches for fn in entry_points}
    log(f"launches over phase 8: {counts8}")
    for k in kernels:
        k["launches"] = counts.get(k["name"], counts8[k["name"]])
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")

    # -- 9. int8 storage ---------------------------------------------------------------
    kernels += int8_phase(dev, card, idx3k, eng3k, qs, entry_points)

    # -- 10. K3 and K4 -------------------------------------------------------------------
    kernels += pair_rerank_phase(dev, card, idx3k, qs, entry_points)
    del eng3k, idx3k, ragged, pooled3k, v76, m76
    torch.cuda.empty_cache()

    # -- 11. the ColSmol-500M embedding path ------------------------------------------------
    kernels.append(embedding_phase(dev, card, (rerank_candidates, rerank_candidates_dedup,
                                               rerank_candidates_sweep), entry_points[1:]))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "visual_rag_tpu"))
    if leaked:
        raise AssertionError(f"the JAX package or jax was imported: {leaked[:5]}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


@contextlib.contextmanager
def uncounted(entry_points):
    """Launches inside the block (kernel-vs-plain checks) leave every
    launch count as it was."""
    saved = [(fn, fn.launches, getattr(fn, "launches_qdot", 0)) for fn in entry_points]
    try:
        yield
    finally:
        for fn, n, nq in saved:
            fn.launches = n
            if hasattr(fn, "launches_qdot"):
                fn.launches_qdot = nq


def int8_phase(dev, card, idx3k, eng3k, qs, entry_points):
    """Phase 9: int8 and int8_refined storage (module docstring). Returns
    the kernel summary entries of the int8 and qdot bodies."""
    import torch

    from visual_rag_tpu_torch import RetrievalEngine, synthetic_index
    from visual_rag_tpu_torch.index.quantize import quantize_index, quantize_rows_int8
    from visual_rag_tpu_torch.ops.kernels.maxsim_rerank import rerank_candidates_ref
    from visual_rag_tpu_torch.ops.kernels.maxsim_scan import exhaustive_scores_packed_ref
    from visual_rag_tpu_torch.ops.kernels.prefetch_topk import (
        _as_packed,
        pooled_maxsim_scores_packed_ref,
    )
    from visual_rag_tpu_torch.retrieval import plans, wire
    from visual_rag_tpu_torch.retrieval.engine import SEARCH_MODES, STAGE1_MODES
    from visual_rag_tpu_torch.retrieval.filters import build_filter
    from visual_rag_tpu_torch.retrieval.local import local_pooled_padded
    from visual_rag_tpu_torch.retrieval.oracle import run_strict_oracle, strict_rank_equal

    k2, k1, k5, k6, k7 = entry_points
    dtypes = ("int8", "int8_refined")
    t0 = time.perf_counter()
    cpu3k = idx3k.to("cpu")
    q_cpu = {dt: quantize_index(cpu3k, dt) for dt in dtypes}
    q_card = {dt: q_cpu[dt].to(dev) for dt in dtypes}
    eng = {dt: RetrievalEngine(q_card[dt]) for dt in dtypes}
    torch.cuda.synchronize()
    log(f"3k corpus quantized on the CPU to {dtypes} and moved to the card in "
        f"{time.perf_counter() - t0:.2f} s")

    # 9a. each int8 and qdot body against its plain version (not counted)
    entries = {}

    def hold(key, fn, ref, args, kw, shape, exact_rows=None):
        got, again, want = fn(*args, **kw), fn(*args, **kw), ref(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=0, atol=ATOL):
            raise AssertionError(f"{key} disagrees with its plain version: {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"{key} is not deterministic")
        if exact_rows is not None:  # one query row a group: bit-equal to the plain version
            rows_kw = dict(kw, qdot_int8=True)
            a, b = fn(*exact_rows, **rows_kw), ref(*exact_rows, **rows_kw)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"{key}: per-row qdot maxima differ from the plain "
                                     f"version by {float((a - b).abs().max())}")
        e = entries.get(key)
        if e is None:  # times at the first (main) shape
            ms = cuda_ms(lambda: fn(*args, **kw))
            plain_ms = cuda_ms(lambda: ref(*args, **kw), iters=3)
            kind = {"rerank_candidates": "rerank", "exhaustive_scores_packed": "scan",
                    "pooled_maxsim_scores_packed": "pooled_packed"}.get(key.split("[")[0],
                                                                        "pooled_padded")
            entries[key] = e = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                "library_ms": None,
                                **maxsim_bound(kind, args, kw.get("qdot_int8", False))}
            log(f"{key} [{shape}]: max_abs_err {err:.3g} kernel {ms:.4f} ms "
                f"plain {plain_ms:.4f} ms{' (per-row qdot maxima bit-equal)' if exact_rows else ''}")
        else:
            e["max_abs_err"] = max(e["max_abs_err"], err)
            log(f"{key} [{shape}]: max_abs_err {err:.3g}")
        return e

    def padded_ref(vals, mask, tokens, qmask, scales_t=None, qdot_int8=False):
        return pooled_maxsim_scores_packed_ref(vals, mask, *_as_packed(vals, tokens, qmask),
                                               scales_t=scales_t, qdot_int8=qdot_int8)

    with uncounted(entry_points):
        r8 = eng["int8"]._fused_arrays("initial")
        store = (r8["flat"], r8["offsets"], r8["lengths"])
        raw, qmask = wire.to_device(wire.pad_queries_raw(queries(11, 32), 128), dev)
        tokens, pooled = plans._prep_queries(raw, qmask)
        _, cand = plans._topk_masked(local_pooled_padded(eng["int8"]._fused_arrays(
            "mean_pooling"), pooled), 200)
        cand[:, -5:] = -1
        hold("rerank_candidates[int8]", k2, rerank_candidates_ref,
             store + (tokens, qmask, cand, r8["max_len"], r8["scales"]), {}, "32 x 200")

        (p, pos, qid), nq, _ = wire.pack_queries_grouped(queries(12, 64), 128)
        packed = plans._prep_queries_packed(*wire.to_device((p, pos, qid), dev), 64, nq)[3]
        m = packed["q"].shape[0]
        one_row = (packed["qid"].reshape(-1, 1) >= 0).int() - 1  # [M, 1]: a group a row
        for body, qdot in (("int8", False), ("qdot", True)):
            hold(f"exhaustive_scores_packed[{body}]", k1, exhaustive_scores_packed_ref,
                 store + (packed["q"], packed["qid"], r8["max_len"], 64, r8["scales"]),
                 dict(qdot_int8=qdot), "64 packed queries x 3000 docs",
                 store + (packed["q"], one_row, r8["max_len"], m, r8["scales"]) if qdot else None)

        s8 = eng["int8"]._fused_arrays("mean_pooling")
        gen = torch.Generator(device=dev)
        gen.manual_seed(14)
        v76 = torch.nn.functional.normalize(
            torch.randn((76, 3000, 128), generator=gen, device=dev), dim=-1)
        c76, sc76 = quantize_rows_int8(v76)
        m76 = torch.rand((76, 3000), generator=gen, device=dev) > 0.3
        m76[:, [17, 2999]] = False
        raw16, qmask16 = wire.to_device(wire.pad_queries_raw(queries(15, 16), 128), dev)
        tokens16, _ = plans._prep_queries(raw16, qmask16)
        for body, qdot in (("int8", False), ("qdot", True)):
            kw = dict(qdot_int8=qdot)
            for vals, mask, sc, shape in ((s8["vals_t"], s8["mask_t"], s8["scales_t"], "P 10"),
                                          (c76, m76, sc76, "P 76 with holes")):
                exact = ((vals, mask, packed["q"], torch.zeros_like(one_row), m, None, sc)
                         if qdot else None)
                hold(f"pooled_maxsim_scores_packed[{body}]", k5,
                     pooled_maxsim_scores_packed_ref,
                     (vals, mask, packed["q"], packed["qid"], 64, packed["w"], sc), kw,
                     f"64 packed queries x 3000 docs, {shape}", exact)
                for fn in (k6, k7):
                    hold(f"{fn.__name__}[{body}]", fn, padded_ref,
                         (vals, mask, tokens16, qmask16, sc), kw,
                         f"16 padded queries x 3000 docs, {shape}")

    # 9b. the int8 path, counts from 0
    for fn in entry_points:
        fn.launches = 0
        if hasattr(fn, "launches_qdot"):
            fn.launches_qdot = 0
    tok = dict(stage1_mode=TOKENS)
    qs16 = qs[:16]
    cuts = dict(BENCH_KW, prefetch_k=60, stage1_k=100, stage2_k=40)
    runs = [dict(cuts, mode=m) for m in SEARCH_MODES] + [
        dict(cuts, stage1_mode=m) for m in STAGE1_MODES[1:]] + [
        dict(cuts, filter_obj=build_filter(year=[2021, 2023]))]
    for dt in dtypes:
        on_cpu = RetrievalEngine(q_cpu[dt])
        for kw in runs:
            a = eng[dt].search_embedded_batch(qs16, **kw)
            b = on_cpu.search_embedded_batch(qs16, **kw)
            key = "score" if kw["mode"].startswith("single_") else "score_final"
            if not all(strict_rank_equal([dict(h, score=h[key]) for h in x], y, score_tol=ATOL)
                       for x, y in zip(b, a)):
                what = " ".join(str(kw[k]) for k in ("mode", "stage1_mode", "filter_obj")
                                if k in kw)
                raise AssertionError(f"{dt}: card and CPU disagree on {what}")
        log(f"3k {dt}: card == cpu by ids in {len(runs)} runs (8 modes, 4 more stage-1 "
            f"modes, 1 filter; 16 queries, padded wire)")

    for dt in dtypes:
        for what, kw in (("pooled", {}), ("tokens", tok)):
            r = qps(eng[dt], qs[:1024], 256, f"3k {dt} {what} bs=256", **kw)
            log(f"3k {dt} two_stage {what} stage-1 bs=256: {r:.1f} QPS [{card}]")
    e8 = eng["int8"]
    for bs in (16, 256):
        r = qps(e8, qs[:512], bs, f"3k int8 single_tiles bs={bs}", mode="single_tiles")
        log(f"3k int8 single_tiles bs={bs}: {r:.1f} QPS [{card}]")
    r = qps(e8, qs[:256], 16, "3k int8 tokens bs=16", **tok)
    log(f"3k int8 two_stage {TOKENS} bs=16 (padded wire): {r:.1f} QPS [{card}]")
    for kw in (dict(BENCH_KW, **tok), dict(BENCH_KW, mode="single_tiles")):
        batch = e8.search_embedded_batch(qs[:8], **kw)
        for q, want_hits in zip(qs[:8], batch):
            if [h["id"] for h in e8.search_embedded(q, **kw)] != [h["id"] for h in want_hits]:
                raise AssertionError(f"int8 per-query search_embedded differs from the batch: "
                                     f"{kw['mode']}")
    log("3k int8 per-query search_embedded (8 queries, tokens two_stage and single_tiles): "
        "same ids as the batch")

    for dt in dtypes:
        ok = run_strict_oracle(eng[dt], qs[:256], idx3k.num_docs, score_tol=0.0)
        exact = eng[dt].search_embedded_batch(qs[:256], mode="single_full", top_k=10,
                                              with_payload=False)
        wide = eng[dt].search_embedded_batch(qs[:256], mode="two_stage", top_k=10,
                                             prefetch_k=idx3k.num_docs, with_payload=False, **tok)
        ok_tok = all(strict_rank_equal(ex, wd, score_tol=0.0) for ex, wd in zip(exact, wide))
        log(f"strict oracle 3k {dt} (256 queries, tol 0): pooled {ok}, tokens {ok_tok}")
        if not (ok and ok_tok):
            raise AssertionError(f"strict oracle failed for {dt}")

    kw = dict(BENCH_KW)
    top_bf16 = [{h["id"] for h in hits} for hits in eng3k.search_embedded_batch(qs[:256], **kw)]
    for dt in dtypes:
        top = [{h["id"] for h in hits} for hits in eng[dt].search_embedded_batch(qs[:256], **kw)]
        ov = float(np.mean([len(a & b) / 10 for a, b in zip(top_bf16, top)]))
        log(f"top-10 overlap of 3k {dt} with the bf16 engine (two_stage, 256 queries): {ov:.4f}")

    # 100k docs: int8_refined, then int8 (one at a time on the card)
    for dt in ("int8_refined", "int8"):
        t0 = time.perf_counter()
        idx = synthetic_index(100000, min_tokens=128, max_tokens=256, pooled_rows=12,
                              storage_dtype=dt, seed=2, device=dev)
        torch.cuda.synchronize()
        ragged = idx.store("initial")
        log(f"100k {dt} corpus: {ragged.flat.shape[0]} rows in {time.perf_counter() - t0:.2f} s")
        bf16 = ragged.flat.numel() * 2 + ragged.offsets.numel() * 8
        log(f"100k token store bytes: bf16 {bf16 / 1e9:.3f} GB (reckoned: same rows, 2 bytes); "
            f"{dt} {ragged.nbytes() / 1e9:.3f} GB = codes {ragged.flat.numel() / 1e9:.3f} + "
            f"res4 {(ragged.res4.numel() if ragged.res4 is not None else 0) / 1e9:.3f} + "
            f"res_scales {(ragged.res_scales.numel() * 4 if ragged.res_scales is not None else 0) / 1e9:.3f} GB"
            f" + scales and offsets; whole index {idx.nbytes() / 1e9:.3f} GB")
        e = RetrievalEngine(idx)
        if dt == "int8_refined":
            (p, pos, qid), nq, _ = wire.pack_queries_grouped(qs[:1024], 128)
            pk = plans._prep_queries_packed(*wire.to_device((p, pos, qid), dev), 1024, nq)[3]
            s100 = e._fused_arrays("mean_pooling")
            args = (s100["vals_t"], s100["mask_t"], pk["q"], pk["qid"], 1024, pk["w"],
                    s100["scales_t"])
            with uncounted(entry_points):
                for body, qdot in (("int8", False), ("qdot", True)):
                    got = k5(*args, qdot_int8=qdot)
                    want = pooled_maxsim_scores_packed_ref(*args, qdot_int8=qdot)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    if not torch.allclose(got, want, rtol=0, atol=ATOL):
                        raise AssertionError(f"K5 {body} disagrees at 100k: {err}")
                    del got, want
                    ms = cuda_ms(lambda: k5(*args, qdot_int8=qdot), iters=3)
                    plain_ms = cuda_ms(lambda: pooled_maxsim_scores_packed_ref(
                        *args, qdot_int8=qdot), iters=1)
                    ent = entries[f"pooled_maxsim_scores_packed[{body}]"]
                    ent.update(max_abs_err=max(ent["max_abs_err"], err), ms_100k=ms,
                               plain_ms_100k=plain_ms, bound_ms_100k=maxsim_bound(
                                   "pooled_packed", args, qdot)["bound_ms"])
                    log(f"pooled_maxsim_scores_packed[{body}] [1024 packed queries "
                        f"({pk['q'].shape[0]} rows) x 100000 docs, P 12]: max_abs_err {err:.3g} "
                        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            for what, kw in (("pooled", {}), ("tokens", tok)):
                r = qps(e, qs, 1024, f"100k {dt} {what}", **kw)
                log(f"100k {dt} two_stage {what} stage-1 bs=1024: {r:.1f} QPS [{card}]")
            r = qps(e, qs[:512], 256, f"100k {dt} single_full", mode="single_full")
            log(f"100k {dt} single_full bs=256: {r:.1f} QPS [{card}]")
            r = qps(e, qs, 1024, f"100k {dt} three_stage", mode="three_stage", stage1_k=1000,
                    stage2_k=300)
            log(f"100k {dt} three_stage bs=1024: {r:.1f} QPS [{card}]")
        else:
            r = qps(e, qs, 1024, f"100k {dt} pooled")
            log(f"100k {dt} two_stage pooled stage-1 bs=1024: {r:.1f} QPS [{card}]")
        del e, idx, ragged
        torch.cuda.empty_cache()

    counts = {f"{fn.__name__}[{body}]": getattr(fn, attr) for fn in entry_points
              for body, attr in (("int8", "launches"), ("qdot", "launches_qdot"))
              if hasattr(fn, attr) and f"{fn.__name__}[{body}]" in entries}
    log(f"launches over phase 9's path: {counts}")
    out = []
    for key, e in entries.items():
        name, body = key[:-1].split("[")
        src = {"rerank_candidates": ("maxsim_rerank.cu", "maxsim_rerank.py:163"),
               "exhaustive_scores_packed": ("maxsim_scan.cu", "maxsim_scan.py:240"),
               "pooled_maxsim_scores_packed": ("pooled_maxsim.cu", "prefetch_topk.py:212"),
               "pooled_maxsim_scores_qbatch": ("pooled_maxsim.cu", "prefetch_topk.py:314"),
               "pooled_maxsim_scores": ("pooled_maxsim.cu", "prefetch_topk.py:358")}[name]
        out.append(dict(name=key, route="cuda", source=f"visual_rag_tpu_torch/csrc/{src[0]}",
                        replaces=f"visual_rag_tpu/ops/kernels/{src[1]}", launches=counts[key],
                        **e))
        if key == "pooled_maxsim_scores_packed[qdot]":  # K9 is this body's function
            out.append(dict(out[-1], name="tpu_tokens_qdot_ab.make_v2 (K9) = " + key,
                            replaces="scripts/tpu_tokens_qdot_ab.py:143"))
    for k in out:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on phase 9's path")
    return out


def timed_once(fn):
    """(result, CUDA-event ms) of a single call."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def pair_rerank_phase(dev, card, idx3k, qs, entry_points):
    """Phase 10: K3 (dedup) and K4 (sweep) (module docstring). Returns their
    kernel summary entries."""
    import torch

    from visual_rag_tpu_torch import RetrievalEngine, synthetic_index
    from visual_rag_tpu_torch.index.quantize import quantize_index
    from visual_rag_tpu_torch.ops.kernels.maxsim_rerank import (
        rerank_candidates_dedup,
        rerank_candidates_dedup_ref,
    )
    from visual_rag_tpu_torch.ops.kernels.maxsim_sweep import (
        rerank_candidates_sweep,
        rerank_candidates_sweep_ref,
    )
    from visual_rag_tpu_torch.retrieval import plans, wire
    from visual_rag_tpu_torch.retrieval.local import local_pooled_padded
    from visual_rag_tpu_torch.retrieval.oracle import run_strict_oracle

    k2 = entry_points[0]
    k3, k4 = rerank_candidates_dedup, rerank_candidates_sweep
    pairs = {"K3": (k3, rerank_candidates_dedup_ref), "K4": (k4, rerank_candidates_sweep_ref)}
    summary = {name: {"max_abs_err": 0.0, "max_abs_diff_k2": 0.0, "shapes": {}}
               for name in pairs}
    all_fns = entry_points + (k3, k4)

    # 10a. each kernel against its plain version and K2 (not counted)
    def hold(store, index, n, iters):
        eng = RetrievalEngine(index)
        ragged = eng._fused_arrays("initial")
        raw, qmask = wire.to_device(wire.pad_queries_raw(qs[:n], 128), dev)
        tokens, pooled = plans._prep_queries(raw, qmask)
        _, cand = plans._topk_masked(
            local_pooled_padded(eng._fused_arrays("mean_pooling"), pooled), 200)
        cand[:, -3:] = -1  # padding slots
        args = (ragged["flat"], ragged["offsets"], ragged["lengths"], tokens, qmask, cand,
                ragged["max_len"], ragged.get("scales"))
        shape = f"{store} {n} x 200"
        times = {"K2": cuda_ms(lambda: k2(*args), iters)}
        base = k2(*args)
        notes = []
        for name, (fn, ref) in pairs.items():
            want, plain_ms = timed_once(lambda: ref(*args))
            got, again = fn(*args), fn(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            diff = float((got - base).abs().max())
            if not torch.allclose(got, want, rtol=0, atol=ATOL):
                raise AssertionError(f"{name} disagrees with its plain version at {shape}: {err}")
            if not torch.equal(got, again):
                raise AssertionError(f"{name} is not deterministic at {shape}")
            times[name] = cuda_ms(lambda: fn(*args), iters)
            times[f"{name} plain"] = plain_ms
            s = summary[name]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            s["max_abs_diff_k2"] = max(s["max_abs_diff_k2"], diff)
            s["shapes"][shape] = {"ms": times[name], "plain_ms": plain_ms, "k2_ms": times["K2"],
                                  "max_abs_err": err, "max_abs_diff_k2": diff,
                                  **maxsim_bound("rerank", args)}
            notes.append(f"{name} max_abs_err {err:.3g}, "
                         + ("bit-equal to K2" if diff == 0 else f"max |K2 diff| {diff:.3g}"))
            del want, got, again
        log(f"K3/K4 [{shape}]: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
            + "; " + "; ".join(notes) + f" [{card}]")

    with uncounted(all_fns):
        q3k = quantize_index(idx3k, "int8")
        for store, index in (("3k bf16", idx3k), ("3k int8", q3k)):
            for n in (32, 256):
                hold(store, index, n, 10)
        del q3k
        for dt in ("bfloat16", "int8"):
            index = synthetic_index(100000, min_tokens=128, max_tokens=256, pooled_rows=12,
                                    storage_dtype=dt, seed=2, device=dev)
            hold(f"100k {'bf16' if dt == 'bfloat16' else dt}", index, 1024, 5)
            del index
            torch.cuda.empty_cache()

    # 10b. the paths that route to K3 and K4, counts from 0
    for fn in all_fns:
        fn.launches = 0
        if hasattr(fn, "launches_qdot"):
            fn.launches_qdot = 0

    def run(what, engine, plain_engine, bs, n, kernel, **kw):
        before = kernel.launches
        route = engine._rerank_impl(bs, kw.get("stage2_k", 200), engine._use_packed(bs))
        r = qps(engine, qs[:n], bs, what, **kw)
        launched = kernel.launches - before
        # the same path with K2, in this call: route, K2, route, K2
        r_plain = qps(plain_engine, qs[:n], bs, what, **kw)
        r2, r2_plain = qps(engine, qs[:n], bs, what, **kw), qps(plain_engine, qs[:n], bs, what, **kw)
        args = dict(BENCH_KW, return_arrays=True, **kw)
        got = engine.search_embedded_batch(qs[:bs], **args)
        want = plain_engine.search_embedded_batch(qs[:bs], **args)
        same = bool(np.array_equal(got.indices, want.indices))
        log(f"{what} ({route} rerank): {r:.1f}, {r2:.1f} QPS (rerank_impl='plain': "
            f"{r_plain:.1f}, {r2_plain:.1f}), {kernel.__name__} launched {launched} "
            f"times in the first, ids == rerank_impl='plain': {same} [{card}]")
        if launched <= 0:
            raise AssertionError(f"{what}: {kernel.__name__} never launched")
        if not same:
            raise AssertionError(f"{what}: ids differ from the plain rerank's")

    for dt in ("bfloat16", "int8_refined"):
        index = synthetic_index(100000, min_tokens=128, max_tokens=256, pooled_rows=12,
                                storage_dtype=dt, seed=2, device=dev)
        eng, plain = RetrievalEngine(index), RetrievalEngine(index, rerank_impl="plain")
        run(f"100k {dt} two_stage bs=1024", eng, plain, 1024, 2048, k3)
        if dt == "bfloat16":
            run(f"100k {dt} two_stage {TOKENS} bs=1024", eng, plain, 1024, 2048, k3,
                stage1_mode=TOKENS)
            run(f"100k {dt} three_stage bs=1024", eng, plain, 1024, 2048, k3,
                mode="three_stage", stage1_k=1000, stage2_k=300)
        del eng, plain, index
        torch.cuda.empty_cache()
    padded = RetrievalEngine(idx3k, query_wire="padded")
    run("3k two_stage padded wire bs=256", padded,
        RetrievalEngine(idx3k, query_wire="padded", rerank_impl="plain"), 256, 1024, k4)
    before = k4.launches
    exact = run_strict_oracle(padded, qs[:64], idx3k.num_docs, score_tol=0.0)
    close = exact or run_strict_oracle(padded, qs[:64], idx3k.num_docs, score_tol=1e-4)
    log(f"strict oracle 3k padded wire (64 queries, prefetch_k = corpus, "
        f"{padded._rerank_impl(64, idx3k.num_docs, False)} rerank): tol 0 {exact}, "
        f"tol 1e-4 {close}; {k4.__name__} launched {k4.launches - before} times")
    if not close:
        raise AssertionError("strict oracle failed on the padded wire (K4)")

    counts = {"K3": k3.launches, "K4": k4.launches}
    log(f"launches over phase 10's path: {counts}")
    main = {"K3": "100k bf16 1024 x 200", "K4": "3k bf16 256 x 200"}  # each one's path shape
    src = {"K3": ("rerank_candidates_dedup", "maxsim_dedup.cu", "maxsim_rerank.py:355"),
           "K4": ("rerank_candidates_sweep", "maxsim_sweep.cu", "maxsim_sweep.py:343")}
    out = []
    for name, s in summary.items():
        fn_name, cu, tpu = src[name]
        at = s["shapes"][main[name]]
        out.append(dict(name=fn_name, route="cuda", source=f"visual_rag_tpu_torch/csrc/{cu}",
                        replaces=f"visual_rag_tpu/ops/kernels/{tpu}", launches=counts[name],
                        max_abs_err=s["max_abs_err"], ms=at["ms"], plain_ms=at["plain_ms"],
                        library_ms=None, bound_ms=at["bound_ms"], bound_by=at["bound_by"],
                        k2_ms=at["k2_ms"], max_abs_diff_k2=s["max_abs_diff_k2"],
                        shapes=s["shapes"]))
    return out


def allowed_pair_count(seg, causal: bool) -> int:
    """Pairs (query i, key j) K10 computes on these segment ids: j in i's
    segment, and j <= i under causal (n(n + 1) / 2 for a segment of n)."""
    import torch

    total = 0
    for row in seg:
        n = torch.unique(row, return_counts=True)[1].long()
        total += int((n * (n + 1) // 2).sum() if causal else (n * n).sum())
    return total


def k10_shape(dev, card, name, dtype, b, t, hq, hkv, seg, causal, iters):
    """K10 against its plain version at one shape (module docstring, 11a):
    max_abs_err, two calls bit-equal, and the CUDA-event ms of K10, of the
    plain version and of SDPA with the same boolean mask."""
    import torch
    import torch.nn.functional as F

    from visual_rag_tpu_torch.ops.kernels.flash_attention import (
        allowed_pairs,
        flash_attention,
        flash_attention_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(t + hq)
    q, k, v = (torch.randn((b, t, h, 64), generator=gen, device=dev).to(dtype)
               for h in (hq, hkv, hkv))
    got, again = (flash_attention(q, k, v, seg, causal=causal) for _ in range(2))
    want = flash_attention_plain(q, k, v, seg, causal=causal)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    if not err <= atol:
        raise AssertionError(f"K10 {name} {dtype}: max_abs_err {err} > {atol}")
    if not torch.equal(got, again):
        raise AssertionError(f"K10 {name} {dtype} is not deterministic")
    del want, again
    ms = cuda_ms(lambda: flash_attention(q, k, v, seg, causal=causal), iters)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, seg, causal=causal), 1)
    rep = hq // hkv  # SDPA reads repeated kv heads and a [B, 1, T, T] mask, built untimed
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k.repeat_interleave(rep, 2),
                                              v.repeat_interleave(rep, 2)))
    mask = torch.stack([allowed_pairs(s, causal) for s in seg])[:, None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                         iters)
    del qt, kt, vt, mask
    pairs = allowed_pair_count(seg, causal)
    nbytes = sum(_nb(x) for x in (q, k, v, got, seg))
    bound_ms, bound_by = bound(nbytes, 4 * 64 * pairs * hq,
                               "bf16" if dtype == torch.bfloat16 else "f32")
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    log(f"K10 {name} {dt} [B {b}, T {t}, heads {hq}/{hkv}, {'causal' if causal else 'segments'}, "
        f"{pairs} allowed pairs a head]: max_abs_err {err:.3g} (atol {atol}), bit-equal twice; "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms SDPA {library_ms:.4f} ms "
        f"bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "pairs_per_head": pairs,
            "shape": [b, t, hq, hkv, 64], "causal": causal}


def synthetic_pages(n_pages: int, tiles: int, seed: int):
    """n_pages random RGB pages (f32 in [0, 1]) 2048 px wide whose ColSmol
    tile grid gives ``tiles`` tiles: 4 columns of 512 px, (tiles - 1) / 4
    rows, plus the global tile."""
    rng = np.random.default_rng(seed)
    height = (tiles - 1) // 4 * 512
    return [rng.random((height, 2048, 3), dtype=np.float32) for _ in range(n_pages)]


def synthetic_queries(n: int, seed: int):
    words = ("revenue chart table figure page report annual growth market share cost "
             "region sales total quarter profit summary").split()
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, int(rng.integers(4, 26)))) for _ in range(n)]


def embedding_phase(dev, card, rerank_fns, search_fns):
    """Phase 11: the ColSmol-500M embedding path (module docstring).
    ``rerank_fns`` are K2, K3 and K4, ``search_fns`` the scan and the
    tokens stage-1 entry points. Returns K10's kernel summary entry."""
    import torch

    from visual_rag_tpu_torch import CollectionSchema, IndexBuilder, RetrievalEngine
    from visual_rag_tpu_torch.models.convert import build_model
    from visual_rag_tpu_torch.models.embedder import VisualEmbedder
    from visual_rag_tpu_torch.ops.kernels.flash_attention import flash_attention
    from visual_rag_tpu_torch.pipeline.vectors import page_vectors
    from visual_rag_tpu_torch.retrieval.oracle import run_strict_oracle

    t_phase = time.perf_counter()
    log("bf16 GEMMs: torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}; allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")

    # 11a. K10 against its plain version at the path's three shapes (not counted)
    def tile_seg(b, n_tiles, t):
        seg = torch.zeros((b, t), dtype=torch.int32, device=dev)
        seg[:, :n_tiles * 1024] = torch.arange(n_tiles * 1024, device=dev) // 1024 + 1
        return seg

    def prefix_seg(lengths, t):
        return (torch.arange(t, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]
                ).to(torch.int32)

    rng = np.random.default_rng(11)
    q_lens = [int(x) for x in rng.integers(5, 31, 64)]
    shapes = {"vision 17 tiles": (1, 17408, 12, 12, tile_seg(1, 17, 17408), False, 5),
              "page text 13 tiles": (4, 896, 15, 5, prefix_seg([836] * 4, 896), True, 10),
              "queries": (64, 30, 15, 5, prefix_seg(q_lens, 30), True, 10)}
    k10 = {}
    for name, (b, t, hq, hkv, seg, causal, iters) in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            k10[f"{name} {'bf16' if dtype == torch.bfloat16 else 'f32'}"] = k10_shape(
                dev, card, name, dtype, b, t, hq, hkv, seg, causal, iters)
            torch.cuda.empty_cache()
    # the pad cost of mixing page sizes in one batch (not counted)
    mixed = tile_seg(2, 17, 17408)
    mixed[1, 5 * 1024:] = 0  # a 5-tile page padded to 17 tiles: one pad segment
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    q = torch.randn((2, 17408, 12, 64), generator=gen, device=dev).to(torch.bfloat16)
    mixed_ms = cuda_ms(lambda: flash_attention(q, q, q, mixed, causal=False), 5)
    alone_ms = cuda_ms(lambda: flash_attention(q[1:, :5120], q[1:, :5120], q[1:, :5120],
                                               mixed[1:, :5120], causal=False), 5)
    log(f"K10 pad cost: a 17-tile page and a 5-tile page padded to 17 tiles in one batch "
        f"{mixed_ms:.4f} ms ({allowed_pair_count(mixed, False)} pairs a head), the 5-tile "
        f"page alone {alone_ms:.4f} ms ({allowed_pair_count(mixed[1:, :5120], False)} pairs a "
        f"head) [{card}]")
    del q, mixed
    flash_attention.launches = 0

    # 11b. full-width ColSmol-500M in bf16, random weights from seed 0
    t0 = time.perf_counter()
    emb = VisualEmbedder("vidore/colSmol-500M", batch_size=8, seed=0, device=dev)
    cfg = emb.cfg
    n_params = sum(p.numel() for p in emb.model.parameters())
    torch.cuda.synchronize()
    log(f"ColSmol-500M (vision {cfg.vision.layers} x {cfg.vision.hidden}, text "
        f"{cfg.text.layers} x {cfg.text.hidden}, {n_params} parameters, {cfg.dtype}) on the "
        f"card in {time.perf_counter() - t0:.2f} s")
    groups = {tiles: synthetic_pages(8, tiles, seed=100 + tiles) for tiles in (5, 9, 13, 17)}
    texts = synthetic_queries(64, seed=12)
    emb.embed_images(groups[5][:2])  # warm batch, not counted
    emb.embed_queries(texts[:4])
    torch.cuda.synchronize()
    counters = (flash_attention,) + tuple(rerank_fns) + tuple(search_fns)
    for fn in counters:
        fn.launches = 0

    # -- the main path: embed pages and queries, pool, seal, search --
    t0 = time.perf_counter()
    pages, infos = [], []
    for tiles, imgs in groups.items():
        e, i = emb.embed_images(imgs, return_token_info=True)
        pages += e
        infos += i
    torch.cuda.synchronize()
    t_pages = time.perf_counter() - t0
    t0 = time.perf_counter()
    emb.processor.process_images(groups[17])
    t_host17 = time.perf_counter() - t0
    t0 = time.perf_counter()
    qs = emb.embed_queries(texts, batch_size=64)
    torch.cuda.synchronize()
    t_queries = time.perf_counter() - t0
    k10_launches = flash_attention.launches
    want = 4 * (cfg.vision.layers + cfg.text.layers) + cfg.text.layers
    log(f"embedded 32 pages (8 each of 5, 9, 13, 17 tiles; batches of one geometry) in "
        f"{t_pages:.3f} s = {32 / t_pages:.2f} pages/s, 64 queries in one batch in "
        f"{t_queries:.3f} s = {64 / t_queries:.1f} queries/s; K10 launched {k10_launches} "
        f"times (4 page batches x {cfg.vision.layers + cfg.text.layers} + 1 query batch x "
        f"{cfg.text.layers} = {want}); the host processor alone takes {t_host17:.3f} s for "
        f"the batch of 8 17-tile pages [{card}]")
    if k10_launches != want:
        raise AssertionError(f"K10 launched {k10_launches} times on the main path, not {want}")
    for e, info in zip(pages, infos):
        if e.shape != (info["num_visual_tokens"] + 4, 128) or not np.isfinite(e).all():
            raise AssertionError(f"a page embedding is {e.shape} or not finite")
        norms = np.linalg.norm(e, axis=1)
        if not np.allclose(norms, 1.0, atol=1e-3):
            raise AssertionError("page token embeddings are not unit vectors")
    if not all(np.isfinite(x).all() and x.shape[1] == 128 and x.shape[0] > 0 for x in qs):
        raise AssertionError("a query embedding is not finite or has the wrong shape")

    t0 = time.perf_counter()
    builder = IndexBuilder(CollectionSchema.standard())
    for i, (e, info) in enumerate(zip(pages, infos)):
        vectors, payload = page_vectors(emb, e, info)
        builder.add(f"page{i}", vectors, dict(payload, tiles=info["num_tiles"]))
    index = builder.seal(device=dev)
    engine = RetrievalEngine(index)
    torch.cuda.synchronize()
    t_seal = time.perf_counter() - t0
    kw = dict(mode="two_stage", top_k=10, prefetch_k=200, with_payload=False)
    t0 = time.perf_counter()
    hits = engine.search_embedded_batch(qs, **kw)
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    # bs 64 on 32 docs reranks by the scan (K1, the policy's pick when the
    # candidates cover the corpus); bs 16 by K2; the tokens stage-1 by K5 / K6
    hits += engine.search_embedded_batch(qs, **kw, stage1_mode=TOKENS)
    for stage1 in ("pooled_query_vs_standard_pooling", TOKENS):
        hits += engine.search_embedded_batch(qs[:16], **kw, stage1_mode=stage1)
    if not all(len(h) == 10 and all(np.isfinite(x["score_final"]) for x in h) for h in hits):
        raise AssertionError("a search over the embedded pages did not answer 10 hits")
    oracle = run_strict_oracle(engine, qs, index.num_docs, score_tol=0.0)
    counts = {fn.__name__: fn.launches for fn in counters}
    log(f"ingest: 32 pages -> page_vectors -> IndexBuilder.seal (bf16, {index.nbytes()} bytes) "
        f"in {t_seal:.3f} s; two_stage (prefetch_k 200, top_k 10) of the 64 embedded queries "
        f"in {t_search:.4f} s; then with the tokens stage-1, and both at bs 16; strict oracle "
        f"(prefetch_k = corpus vs single_full, tol 0): {oracle}; launches over the main path: "
        f"{counts} [{card}]")
    if not oracle:
        raise AssertionError("strict oracle failed on the embedded corpus")
    for what, fns in (("K2", rerank_fns[:1]), ("the scan", search_fns[:1]),
                      ("a tokens stage-1 kernel", search_fns[1:])):
        if sum(fn.launches for fn in fns) <= 0:
            raise AssertionError(f"the search over the embedded pages never launched {what}")

    # where a page batch's time goes: one profiled batch of 8 17-tile pages
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        emb.embed_images(groups[17])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms = {}  # device kernels and copies only: a CPU op's device time repeats its kernels'
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            dev_ms[ev.key] = dev_ms.get(ev.key, 0.0) + us / 1e3
    total = sum(dev_ms.values())
    k10_dev = sum(v for k, v in dev_ms.items() if "flash_fwd" in k)
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:6]
    log(f"profile, one batch of 8 17-tile pages: wall {wall * 1e3:.1f} ms (profiled), device "
        f"{total:.1f} ms (busy {total / (wall * 1e3):.2f}), K10 {k10_dev:.1f} ms; top device "
        "items: " + "; ".join(f"{k[:60]} {v:.1f} ms" for k, v in top) + f" [{card}]")

    # 11c. the whole-model yardstick: the same weights with the dense attention
    dense = VisualEmbedder("vidore/colSmol-500M", batch_size=8, params=emb.params, device=dev)
    dense.model.use_flash = False
    for what, a, b in (("2 pages of 5 tiles", emb.embed_images(groups[5][:2]),
                        dense.embed_images(groups[5][:2])),
                       ("16 queries", emb.embed_queries(texts[:16], batch_size=16),
                        dense.embed_queries(texts[:16], batch_size=16))):
        cos = min(float((x * y).sum(axis=1).min()) for x, y in zip(a, b))
        diff = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
        log(f"yardstick ({what}): K10 path vs use_flash=False (dense), the same bf16 weights: "
            f"min per-token cosine {cos:.6f}, max abs diff {diff:.3g}")
        if cos < 0.99:
            raise AssertionError(f"K10 path and dense attention disagree on {what}: {cos}")
    del dense

    # 11d. card against CPU: the full-width model in f32 on both devices
    import dataclasses

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    sd32 = {k: v.float().cpu() for k, v in emb.params.items()}
    short = texts[:4]
    ids, mask = emb.processor.process_queries(short)
    outs = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        model = build_model(cfg32, sd32, d)
        with torch.inference_mode():
            outs[where] = model.embed_queries(torch.from_numpy(ids).to(d),
                                              torch.from_numpy(mask).to(d)).cpu()
        del model
    err32 = float((outs["card"] - outs["cpu"]).abs().max())
    log(f"card vs CPU, full-width ColSmol-500M in f32, 4 queries: max abs diff {err32:.3g} "
        f"(atol 1e-3)")
    if err32 > 1e-3:
        raise AssertionError(f"the f32 model on the card and on the CPU differ by {err32}")
    del emb, sd32, outs
    torch.cuda.empty_cache()
    log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")

    main = k10["vision 17 tiles bf16"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "visual_rag_tpu_torch/csrc/flash_attention.cu",
            "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
            "launches": k10_launches,
            "max_abs_err": max(v["max_abs_err"] for k, v in k10.items() if "bf16" in k),
            "max_abs_err_f32": max(v["max_abs_err"] for k, v in k10.items() if "f32" in k),
            **{key: main[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by")},
            "shapes": k10}


if __name__ == "__main__":
    main()
