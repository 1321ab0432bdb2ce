"""Drive the PyTorch/CUDA port's query path once on one GPU and check it.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, in order; any failure raises and the script exits non-zero:

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, then the kernels built from ``visual_rag_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes on the 3k-doc bf16 corpus (rerank: 32 queries x 200
   candidates with some -1; scan: 64 packed queries x every doc), within
   atol 1e-3; then the engine on a small corpus, on the card against the
   same index on the CPU.
3. The main path: ``two_stage`` (prefetch_k=200, top_k=10) through
   ``search_embedded_batches`` at bs 32, 256 and 1024 on the 3k corpus.
4. The strict oracle at 3k on 256 queries at score tolerance 0.
5. 100k docs: ``two_stage`` at bs 1024, ``single_full`` at bs 256 and the
   strict oracle on 64 queries.
6. Serving: the port's SearchServer answers 8 concurrent POST /search with
   the ids a direct ``search_embedded_batch`` gives.
7. Launch counts of both kernels over phases 3-6; each must be > 0.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON summary. Without a CUDA device the script raises at once.
"""

from __future__ import annotations

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
        rerank_candidates_ref,
    )
    from visual_rag_tpu_torch.ops.kernels.maxsim_scan import (
        exhaustive_scores_packed,
        exhaustive_scores_packed_ref,
    )
    from visual_rag_tpu_torch.retrieval import plans, wire
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
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

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
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    # float32: queries normalised on the card and on the CPU differ in the last
    # f32 bit, which a cast to a 2-byte store dtype can turn into a whole ulp
    small = synthetic_index(200, min_tokens=64, max_tokens=300, pooled_rows=10,
                            storage_dtype="float32", seed=4, device="cpu")
    qs_small = queries(13, 64)
    for wire_kind in ("padded", "packed"):
        on_card = RetrievalEngine(small.to(dev), query_wire=wire_kind)
        on_cpu = RetrievalEngine(small, query_wire=wire_kind)
        for kw in (dict(BENCH_KW), dict(BENCH_KW, prefetch_k=200, mode="single_full")):
            a = on_card.search_embedded_batch(qs_small, **kw)
            b = on_cpu.search_embedded_batch(qs_small, **kw)
            key = "score" if kw["mode"] == "single_full" else "score_final"
            ok = all(strict_rank_equal([dict(h, score=h[key]) for h in x], y, score_tol=1e-4)
                     for x, y in zip(b, a))
            log(f"small corpus {wire_kind} {kw['mode']}: card == cpu plain: {ok}")
            if not ok:
                raise AssertionError(f"card and CPU disagree on {wire_kind} {kw['mode']}")

    # -- 3. main path at the bench protocol ----------------------------------------
    rerank_candidates.launches = 0
    exhaustive_scores_packed.launches = 0
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
    del eng100k, idx100k

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
              "exhaustive_scores_packed": exhaustive_scores_packed.launches}
    log(f"launches over the main path: {counts}")
    for k in kernels:
        k["launches"] = counts[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main path")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
