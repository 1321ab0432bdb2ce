"""Check the PyTorch/CUDA port's kernels and its query, embedding and training paths on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

It times kernels (CUDA events, beside their plain versions and bounds) and
checks answers and launch counts; it does not rate the engine, which the
benchmark's cells (``bench_port/``) measure. Each search below is one
untimed pass whose every batch must answer 10 valid hits.

Phases, in order; any failure raises and the script exits non-zero:

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, then the kernels built from ``visual_rag_tpu_torch/csrc``, with
   the build log's ptxas lines and the library's SASS (``cuobjdump -sass``):
   the twenty bf16 instances of K10's two forwards, B4 and B5 issue HMMA
   (``mma.sync`` on the tensor cores), the twenty f32 ones none.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes on the 3k-doc bf16 corpus (rerank: 32 queries x 200
   candidates with some -1; scan: 64 packed queries x every doc; tokens
   stage-1: 64 packed queries (K5) and 16 padded queries (K6, K7) x the
   P = 10 pooled store, and again x a P = 76 store with mask holes and two
   docs with no valid row), within atol 1e-3, two calls bit-equal; the pooled
   stage-1 kernel (``pooled_stage1_scores_ref`` beside it) on bf16, f16 and
   int8 stores (``pooled_stage1_phase``), then timed at the search cell's
   shape (1024 queries x 200k docs, P 32, bf16) and at one query; then the
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
7. Launch counts of K2, K3, the scan and the pooled stage-1 over phases 3-6;
   each must be > 0, and K3's all of its tensor-core body
   (``rerank_candidates_dedup.mma_launches``). Every strict oracle of the
   script holds at tolerance 0, or at 1e-4 where its wide side ran K3's
   tensor-core body (``strict_oracle``, ROADMAP check 2).
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
   queries, ids); ``two_stage`` at 3k bs 256 (pooled and tokens, both
   dtypes); ``single_tiles`` at bs 16 and 256 and the tokens ``two_stage``
   at bs 16;
   per-query ``search_embedded`` (K7); the strict oracles at tolerance 0
   for both dtypes and both stage-1 kinds; the top-10 overlap with the bf16
   engine; at 100k ``int8_refined`` ``two_stage`` bs 1024 (pooled, tokens),
   ``single_full`` bs 256, ``three_stage`` bs 1024, and ``int8`` ``two_stage``
   bs 1024; the token store's bytes per dtype. Every entry point's int8
   count and every qdot count must be > 0.
10. K3 (dedup) and K4 (sweep), the reranks the policy picks for batches of
   64 and more (K4 where the candidates cover the store six times and more).
   First, not counted: each against its plain version (within ATOL, two calls
   bit-equal) and against K2 on the same inputs: K4 bit-equal (it shares
   K2's row dots and fold), K3 within ATOL, its largest difference logged
   (on bf16 and int8 stores its tensor-core body sums each dot in the
   tensor cores' order); with the CUDA-event ms of K2, K3, K4 and both plain
   versions, at 32 x 200 and 256 x 200 on the 3k corpus and 1024 x 200 at
   100k, on bf16 and on ``int8`` (the plain versions once at 100k), and at
   256 x 200 on the 3k corpus in f32, where K3 keeps its CUDA-core body
   (bit-equal to K2); the tensor-core body's launches counted at each
   (2 a shape on bf16 and int8, none on f32); then K3
   at the search cell's shape (``k3_cell_shape``: 1024 queries of 12-32 rows
   x 200 candidates over 200k docs of 992-1024 rows, bf16), timed beside K2
   and its bound; the ptxas lines of the tensor-core body's three instances
   (0 spill bytes asserted). Then, counts at 0: at 100k bf16 ``two_stage`` bs
   1024 (pooled, then tokens stage-1) and ``three_stage`` bs 1024, at 100k
   ``int8_refined`` pooled ``two_stage`` bs 1024 (K3 each, count > 0, every
   launch the tensor-core body's: ``mma_launches`` == ``launches``), and
   on the 3k corpus on the padded wire at bs 256 (K4, count > 0), each with
   ids equal to the same engine's with ``rerank_impl="plain"`` (K2);
   the strict oracle on the padded 3k engine (64 queries, ``prefetch_k`` =
   corpus: K4 against ``single_full``'s K1), logged at tolerance 0 and
   required at 1e-4.
11. The ColSmol-500M embedding path. First, not counted: K10 (flash
   attention) against its plain version at the path's shapes -- vision, one
   page of 17 tiles (T 17408, 12 heads, per-tile segments); page text, 4
   pages of 13 tiles (T 896, 15 / 5 heads, causal, pads); 64 queries (T 30,
   causal) -- in bf16 (within one output ulp: |got - want| <= 2**-7 |want|
   + 1e-5 for each element) and f32 (atol 1e-4), two calls bit-equal,
   with the CUDA-event ms of K10, of the plain version and of SDPA with the
   same boolean mask; and K10's time on a batch that pads a 5-tile page to
   17 tiles. Then, counts at 0, the main path: full-width ColSmol-500M in
   bf16 with random weights from seed 0 embeds 32 pages (8 each of 5, 9, 13
   and 17 tiles, a batch per geometry) and 64 queries after a warm batch
   (K10 launched layers x batches times), the pages go
   through ``page_vectors`` and ``IndexBuilder.seal`` (bf16) into the
   engine, which answers ``two_stage`` (prefetch_k 200, top_k 10) with the
   embedded queries at bs 64 and 16 with both stage-1 modes, and the strict
   oracle holds at tolerance 0; K2, the scan and a tokens stage-1 kernel
   must each have launched. Then, not counted: the same weights with
   ``use_flash=False`` (dense attention) on 2 pages and 16 queries, per-token
   cosine >= 0.99; and the full-width model in f32 on the card and on the
   CPU, 4 queries, atol 1e-3.
12. The ColPali-v1.3 embedding path (PaliGemma-3B: SigLIP-So400m, 27 x 1152
   with 16 heads of 72; Gemma-2B, 18 x 2048 with 8 heads of 256 on one kv
   head, bidirectional). First, not counted: K10 against its plain version
   at the path's shapes -- vision, one page (T 1024, 16 heads of 72, no
   pads); page text, 4 pages (T 1088 of which 1028 valid, 8 / 1 heads of
   256); 64 queries of 6-30 tokens (T 32) -- in bf16 and f32 at phase 11's
   limits, two calls bit-equal, with the CUDA-event ms of K10, the
   plain version and SDPA. Then, counts at 0, the main path: full-width
   ColPali-v1.3 in bf16, random weights from seed 0 drawn on the card, embeds
   32 pages of four aspect ratios in batches of 8 and 64 queries after a
   warm batch (K10 launched 4 x (27 + 18) + 18 times),
   ``page_vectors`` -> ``IndexBuilder(CollectionSchema.standard(
   experimental_names=plan["names"]))`` -> seal (bf16) ->
   ``RetrievalEngine(index, stage1_cut="exact")``, ``two_stage``
   (prefetch_k 200, top_k 10) with both stage-1 modes at bs 64 and 16, the
   strict oracle at tolerance 0, rerank and stage-1 launches > 0. Then,
   not counted: the dense-attention
   yardstick on 2 pages and 16 queries (cosine >= 0.99), and the card
   against the CPU in f32 at full width, the depth cut to 2 vision and 2
   text layers (a full f32 ColPali is 11.8 GB on each side), 4 queries and
   1 page, atol 1e-3.
13. The ColQwen2.5-v0.2 embedding path (Qwen2.5-VL-3B: a 32 x 1280 vision
   tower, 16 heads of 80 with the 2-D rotary, 8 x 8 patch window segments
   except in layers 7, 15, 23 and 31; the 2 x 2 PatchMerger; a Qwen2.5 text
   model, 36 x 2048 with 16 heads of 128 on 2 kv heads, causal, M-RoPE).
   First, not counted: K10 against its plain version at the path's four
   shapes -- one A4 page's vision in a window layer (T 4096, the
   processor's real window ids, pads) and in a full layer; 4 pages' text (T
   1024, causal); 64 queries (T 32) -- in bf16 and f32 at phase 11's
   limits, two calls bit-equal, with the CUDA-event ms of K10, the plain
   version and SDPA, and the ptxas registers and spills of the Dh 80 and
   128 serving instances (0 spill bytes required). Then ColPali's model is
   freed and, counts at 0, the main path: full-width ColQwen2.5-v0.2 in bf16
   (3963137408 parameters, asserted), random weights from seed 0 drawn on
   the card, embeds 32 pages of ColPali's four aspect ratios in batches of 8
   (every page padded to 4096 patches) and 64 queries in one batch, after a
   warm batch (K10 launched 32 + 36 times a page batch and 36 a query
   batch),
   ``page_vectors`` (gaussian and triangular smoothing and the
   ``experimental_pooling`` alias) -> seal (bf16) ->
   ``RetrievalEngine(index, stage1_cut="exact")``, ``two_stage`` with both
   stage-1 modes at bs 64 and 16, the strict oracle at tolerance 0. Then,
   not counted: the dense-attention
   yardstick on 2 pages and 16 queries (cosine >= 0.99), and the card
   against the CPU in f32 at full width, the depth cut to 2 vision layers
   (the second full attention) and 2 text layers, 1 page (window ids and
   patch positions passed on both devices) and 4 queries, atol 1e-3.
14. ColSmol-500M training (K10's forward with its logsumexp, B4 and B5).
   First, not counted, at the path's shapes -- vision, one 17-tile page (T
   17408, 12 heads, per-tile segments); page text, 4 pages of 13 tiles (T
   896, 15 on 5 heads, causal, pads); 4 queries (T 30, causal) -- in bf16
   and f32: the forward that saves lse against its plain version (out
   within ``K10_TOL``, lse within ``LSE_ATOL``, two calls bit-equal, out
   equal to the serving forward's); B4 (dK, dV) and B5 (dQ) against their
   plain versions, called directly and through the autograd Function's
   backward with a random dO: dq, dk and dv each within ``BWD_TOL`` (f32
   1e-4 of the tensor's largest; bf16 one output ulp plus 1e-5 of the
   largest), two calls bit-equal and equal to the Function's. The
   CUDA-event ms of the three kernels, their plain versions and SDPA (its
   forward on inputs that need grad; its backward alone) with the same
   boolean mask, and the ptxas lines of the eight flash instances (K10's
   two forwards, B4 and B5, f32 and bf16) and of B4's reduction of a split
   head group (0 spill bytes required). Then full-width
   ColSmol-500M (460296512 parameters asserted; f32 master weights from
   seed 0 drawn on the card, bf16 compute), ``Trainer(lr=1e-4, warmup=0)``,
   one batch of 4 (query, page) pairs from the port's processor (17-tile
   random pages with their window ids, 4 random queries): ``remat=True``
   gives the same loss and gradients; a warm step, then, counts at 0, the
   main path: 5 steps (peak memory; each loss finite and the last below the
   warm one's; the forward that saves lse, B4 and B5 launched 76 times a step
   each: 12 vision + 32 page text + 32 query text layers; the serving forward
   never); ``ema_update`` of the parameters before and after the 5 steps
   against the f64 lerp; a checkpoint saved, restored and stepped once, equal
   to a step from the live state. Then, not counted: one step's loss and
   gradients in f32 on the card against the CPU at full width, the depth cut
   to 2 + 2 layers, 2 pairs of 5-tile pages (loss 1e-4 relative; each leaf
   within 1e-3 of its own largest, except the leaves at f32 rounding level on
   the CPU, ``ROUNDING_SHARE``, which may be only the key biases).
15. ColPali-v1.3 training (K10's forward with its logsumexp, B4 and B5 at
   head dims 72 and 256). Phase 14's state is freed first. First, not
   counted, at the path's shapes -- vision, 1 and 4 pages (T 1024, 16 heads
   of 72, one segment); page text, 4 pages (T 1088 of which 1028 valid, 8
   heads of 256 on one kv head, bidirectional); 4 queries (T 32) -- in bf16
   and f32: the three kernels against their plain versions as in 14a, with
   the ptxas lines of the sixteen Dh 72 and 256 flash instances and the
   reduction (0 spill bytes required). Then one batch of 4 (query, page)
   pairs from the port's processor (random 448 x 448 pages, 1024 patches
   each, 4 random queries);
   at a depth cut to 9 vision + 6 text layers (which fits without remat)
   ``remat=False`` gives the same loss and gradients as ``remat=True``.
   Then full-width ColPali-v1.3 (``COLPALI_PARAMS`` asserted; f32 master
   weights from seed 0 drawn on the card, bf16 compute, ``remat=True``),
   ``Trainer(lr=1e-4, warmup=0)``: a warm step in its two halves, to split
   the peak memory into the state, the forward and backward, and the
   optimizer's transient; then, counts at 0, the main path: 5 steps (peak
   memory; each loss finite; B4 and B5 launched 63 times a step each, 27
   vision + 18 page text + 18 query text layers, the forward that saves lse
   twice that, since remat runs each block's forward again in the backward,
   the serving forward never). Then, not counted: one step's loss and
   gradients in f32 on the card against the CPU at full width cut to 2 + 2
   layers, 2 pairs (as 14c); and the CLI, ``cli.train_colvlm --model
   vidore/colpali-v1.3 --synthetic --device cuda``, 3 steps without remat at
   the larger of 4 and 2 pairs that fits (``CLI_BATCHES``; its checkpoint
   written under ``build/`` and deleted).
16. ColQwen2.5-v0.2 training (K10's forward with its logsumexp, B4 and B5 at
   head dims 80 and 128). Phase 15's state is freed first (less than 1 GiB
   may stay allocated). One batch of 4 (query, page) pairs from the port's
   processor: random A4 pages (74 x 54 patches, padded to 4096, with their
   window ids; page text T ~1024) and 4 random queries. First, not counted,
   at the path's shapes -- vision in a window layer, 1 and 4 pages (16 heads
   of 80, the processor's window ids, pads), in a full layer, 1 page; page
   text, 4 pages (16 heads of 128 on 2 kv heads, causal, pads); 4 queries --
   in bf16 and f32: the three kernels against their plain versions as in
   14a, the window layer's live tile pairs beside the allowed pairs, the
   ptxas lines of the sixteen Dh 80 and 128 flash instances and the
   reduction (0 spill bytes required). Then at a depth cut to 8 vision
   layers (the eighth full) + 4 text layers, which fits without remat,
   ``remat=False`` gives the same loss and gradients as ``remat=True``.
   Then full-width ColQwen2.5-v0.2 (``COLQWEN_PARAMS`` asserted; f32 master
   weights from seed 0 drawn on the card, bf16 compute, ``remat=True``),
   ``Trainer(lr=1e-4, warmup=0)``: a warm step in its two halves (the
   memory split, as 15b); then, counts at 0, the main path: 5 steps (peak
   memory below the card's; each loss finite; B4 and B5 launched 104 times
   a step each, 32 vision + 36 page text + 36 query text layers, the lse
   forward 208, the serving forward never). Then, not counted: one step's
   loss and gradients in f32 on the card against the CPU at full width cut
   to 2 vision layers (the second full) + 2 text layers, 2 pairs of 448 x
   448 pages (1024 patches), as 14c. The patch positions stay out of the
   batch, as the trainer drops them (the JAX ``Trainer`` never passes them).

17. K11, the routed experts of Kimi-VL-A3B (``moe_experts_phase``): at its
   widths on the ingest cell's batch, a uniform and a skewed layout against
   the plain version, two calls bit-equal, launches counted, then timed
   beside the plain version and its bound.

The build's log gives each kernel's registers and spills (``-Xptxas=-v``).
Every kernel entry carries ``bound_ms`` (the larger of its bytes over 3.35
TB/s and its operations over the peak rate of their type: 989 TFLOP/s bf16,
67 TFLOP/s f32, 1979 TOP/s int8), ``bound_by``, and ``library_ms`` (SDPA for
K10; null for the MaxSim kernels, which no single PyTorch call computes).
K10's one entry holds every shape of phases 11, 12 and 13 under ``shapes``,
the head dims it ran (64, 72, 80, 128, 256), its launches on each
embedding path and the ptxas lines and HMMA counts of its serving instances;
the entries of the forward that saves lse
(``flash_attention_fwd``; ``library_ms``: SDPA's forward on inputs that
need grad), B4 and B5 (``library_ms``: SDPA's whole backward) hold the
shapes of phases 14, 15 and 16, their ptxas lines (B4's with its reduction),
their HMMA counts by instance, the head dims they ran
(64, 72, 80, 128, 256) and their launches on each training path
(``launches_by_path``: colsmol, colpali, colqwen2.5).
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

from visual_rag_tpu_torch.tools.peaks import HBM_BYTES_PER_S, PEAK_OPS

ROOT = Path(__file__).resolve().parent
BENCH_KW = dict(mode="two_stage", top_k=10, prefetch_k=200, with_payload=False)
TOKENS = "tokens_vs_standard_pooling"  # the pipeline's own stage-1 (demo/commands.py:47)
ATOL = 1e-3  # bf16 inputs, f32 accumulation in both: only the summation order differs
# K10 against its plain version, (rtol, atol) for each element. Both round f32 values of the
# same inputs to the output dtype, so in bf16 they may differ by one output ulp, at most 2**-7
# of |want| (rms 0.04 in a full T 4096 vision layer), plus a floor for values near 0
K10_TOL = {"f32": (0.0, 1e-4), "bf16": (2.0 ** -7, 1e-5)}


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


def search_pass(engine, qs, bs: int, what: str, **kw) -> None:
    """``qs`` once through ``search_embedded_batches`` in batches of ``bs``
    (``BENCH_KW`` unless ``kw`` says otherwise), each batch checked."""
    kw = dict(BENCH_KW, return_arrays=True, **kw)
    for res in engine.search_embedded_batches([qs[s:s + bs] for s in range(0, len(qs), bs)],
                                              **kw):
        check_results(res, bs, what)


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
        pooled_stage1_scores,
    )
    from visual_rag_tpu_torch.retrieval import plans, wire
    from visual_rag_tpu_torch.retrieval.engine import SEARCH_MODES, STAGE1_MODES
    from visual_rag_tpu_torch.retrieval.filters import build_filter
    from visual_rag_tpu_torch.retrieval.local import local_pooled_padded
    from visual_rag_tpu_torch.retrieval.oracle import strict_rank_equal
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
    for entry, lines in ptxas_report().items():  # registers and spills, by mangled name
        for line in lines:
            log(f"  ptxas {entry}: {line}")
    hmma = flash_tensor_cores()

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

    stage1_entry = pooled_stage1_phase(dev, card)
    torch.cuda.empty_cache()

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
               exhaustive_scores_packed, pooled_stage1_scores):
        fn.launches = 0
    rerank_candidates_dedup.mma_launches = 0
    qs = queries(1, 2048)
    for bs, n in ((32, 512), (256, 2048), (1024, 2048)):
        search_pass(eng3k, qs[:n], bs, f"3k bs={bs}")
        log(f"3k two_stage bs={bs}: {n} queries, 10 valid hits each")

    # -- 4. strict oracle at 3k ----------------------------------------------------
    ok3k, tol3k = strict_oracle(eng3k, qs[:256], idx3k.num_docs)
    log(f"strict oracle 3k (256 queries, tol {tol3k:g}): {ok3k}")
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
    search_pass(eng100k, qs, 1024, "100k bs=1024")
    log("100k two_stage bs=1024: 2048 queries, 10 valid hits each")
    search_pass(eng100k, qs[:512], 256, "100k single_full", mode="single_full")
    log("100k single_full bs=256: 512 queries, 10 valid hits each")
    ok100k, tol100k = strict_oracle(eng100k, qs[:64], idx100k.num_docs)
    log(f"strict oracle 100k (64 queries, tol {tol100k:g}): {ok100k}")
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
              "exhaustive_scores_packed": exhaustive_scores_packed.launches,
              "pooled_stage1_scores": pooled_stage1_scores.launches}
    log(f"launches over phases 3-6: {counts}; of K3's, the tensor-core body's "
        f"(rerank_candidates_dedup.mma_launches): {rerank_candidates_dedup.mma_launches}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    if rerank_candidates_dedup.mma_launches != rerank_candidates_dedup.launches:
        raise AssertionError("K3 ran its CUDA-core body on a bf16 store at dim 128")

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
        search_pass(eng3k, qs[:n], bs, f"3k tokens bs={bs}", **tok)
    search_pass(eng100k, qs, 1024, "100k tokens bs=1024", **tok)
    search_pass(eng100k, qs, 1024, "100k three_stage", mode="three_stage", stage1_k=1000,
                stage2_k=300)
    del eng100k, idx100k
    search_pass(eng3k, qs, 256, "3k single_tiles", mode="single_tiles")
    log(f"two_stage {TOKENS} at 3k bs 16 (padded wire) and 256 (packed), at 100k bs 1024; "
        "three_stage at 100k bs 1024 (stage1_k 1000, stage2_k 300); single_tiles at 3k bs "
        "256: 10 valid hits each")

    for i, pl in enumerate(idx3k.manifest.payloads):
        pl["year"] = 2020 + i % 4
    filt = build_filter(year=[2021, 2023])
    hits = eng3k.search_embedded_batch(qs[:512], **dict(BENCH_KW, with_payload=True), **tok,
                                       filter_obj=filt)
    if not all(len(h) == 10 and all(x["payload"]["year"] in (2021, 2023) for x in h)
               for h in hits):
        raise AssertionError("a filtered search returned a hit outside the filter")
    search_pass(eng3k, qs[:2048], 256, "3k filtered", filter_obj=filt, **tok)
    log(f"3k two_stage {TOKENS} filtered year in (2021, 2023): every hit satisfies the filter")

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
    stage1_entry["launches"] = counts["pooled_stage1_scores"]
    for k in kernels:
        k["launches"] = counts.get(k["name"], counts8[k["name"]])
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    kernels.append(stage1_entry)

    # -- 9. int8 storage ---------------------------------------------------------------
    kernels += int8_phase(dev, card, idx3k, eng3k, qs, entry_points)

    # -- 10. K3 and K4 -------------------------------------------------------------------
    kernels += pair_rerank_phase(dev, card, idx3k, qs, entry_points)
    del eng3k, idx3k, ragged, pooled3k, v76, m76
    torch.cuda.empty_cache()

    # -- 11. the ColSmol-500M embedding path ------------------------------------------------
    rerank_fns = (rerank_candidates, rerank_candidates_dedup, rerank_candidates_sweep)
    k10 = embedding_phase(dev, card, rerank_fns, entry_points[1:])

    # -- 12. the ColPali-v1.3 embedding path ------------------------------------------------
    colpali = colpali_phase(dev, card, rerank_fns, entry_points[1:])

    # -- 13. the ColQwen2.5-v0.2 embedding path ---------------------------------------------
    colqwen = colqwen_phase(dev, card, rerank_fns, entry_points[1:])

    # -- 14. ColSmol-500M training: K10 with lse, B4 and B5 ---------------------------------
    training = training_phase(dev, card, hmma)
    k10["launches_by_path"] = {"colsmol": k10["launches"], "colpali": colpali["launches"],
                               "colqwen2.5": colqwen["launches"]}
    k10["launches"] += colpali["launches"] + colqwen["launches"]
    k10["shapes"].update(colpali["shapes"])
    k10["shapes"].update(colqwen["shapes"])
    k10["ptxas"] = {k: v for k, v in ptxas_report().items() if serving_instance(k)}
    k10["hmma"] = {k: v for k, v in hmma.items() if serving_instance(k)}
    k10["head_dims"] = sorted({v["shape"][4] for v in k10["shapes"].values()})
    k10["max_abs_err"] = max(v["max_abs_err"] for k, v in k10["shapes"].items() if "bf16" in k)
    k10["max_abs_err_f32"] = max(v["max_abs_err"] for k, v in k10["shapes"].items()
                                 if "f32" in k)
    k10["of_limit"] = max(v["of_limit"] for v in k10["shapes"].values())  # <= 1 (K10_TOL)
    kernels.append(k10)

    # -- 15. ColPali-v1.3 training: K10 with lse, B4 and B5 at Dh 72 and 256 ----------------
    colpali_train = colpali_training_phase(dev, card)
    torch.cuda.empty_cache()

    # -- 16. ColQwen2.5-v0.2 training: K10 with lse, B4 and B5 at Dh 80 and 128 -------------
    colqwen_train = colqwen_training_phase(dev, card)
    kernels += merge_training_entries(training, {"colpali": colpali_train,
                                                 "colqwen2.5": colqwen_train})
    torch.cuda.empty_cache()

    # -- 17. K11, the routed experts, at Kimi-VL-A3B's widths ------------------------------
    kernels.append(moe_experts_phase(dev, card))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "visual_rag_tpu"))
    if leaked:
        raise AssertionError(f"the JAX package or jax was imported: {leaked[:5]}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


def ptxas_report() -> dict:
    """{mangled kernel name: its ptxas -v lines on registers and spills},
    from the build's log (empty where this process loaded a cached build
    whose log is gone)."""
    from visual_rag_tpu_torch.ops.kernels import _build

    build_log = _build.library_path().with_suffix(".log")
    out, entry = {}, ""
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                out.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return out


@contextlib.contextmanager
def uncounted(entry_points):
    """Launches inside the block (kernel-vs-plain checks) leave every
    launch count as it was."""
    saved = [(fn, fn.launches, getattr(fn, "launches_qdot", 0), getattr(fn, "mma_launches", 0))
             for fn in entry_points]
    try:
        yield
    finally:
        for fn, n, nq, nm in saved:
            fn.launches = n
            if hasattr(fn, "launches_qdot"):
                fn.launches_qdot = nq
            if hasattr(fn, "mma_launches"):
                fn.mma_launches = nm


def strict_oracle(engine, queries, num_docs, top_k=10):
    """ROADMAP check 2 on the card, run once: ``single_full`` against
    ``two_stage`` (``prefetch_k`` = corpus) under ``strict_rank_equal`` at
    tolerance 0, or at 1e-4 where the wide side ran K3's tensor-core body,
    whose dots sum in the tensor cores' order (``single_full`` never runs
    it). Returns (ok, the tolerance it held)."""
    from visual_rag_tpu_torch.ops.kernels.maxsim_rerank import rerank_candidates_dedup
    from visual_rag_tpu_torch.retrieval.oracle import strict_rank_equal

    kw = dict(top_k=top_k, with_payload=False)
    exact = engine.search_embedded_batch(queries, mode="single_full", **kw)
    before = rerank_candidates_dedup.mma_launches
    wide = engine.search_embedded_batch(queries, mode="two_stage", prefetch_k=num_docs, **kw)
    tol = 1e-4 if rerank_candidates_dedup.mma_launches > before else 0.0
    return all(strict_rank_equal(ex, wd, score_tol=tol) for ex, wd in zip(exact, wide)), tol


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
    from visual_rag_tpu_torch.retrieval.oracle import strict_rank_equal

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
            search_pass(eng[dt], qs[:1024], 256, f"3k {dt} {what} bs=256", **kw)
    e8 = eng["int8"]
    for bs in (16, 256):
        search_pass(e8, qs[:512], bs, f"3k int8 single_tiles bs={bs}", mode="single_tiles")
    search_pass(e8, qs[:256], 16, "3k int8 tokens bs=16", **tok)
    for kw in (dict(BENCH_KW, **tok), dict(BENCH_KW, mode="single_tiles")):
        batch = e8.search_embedded_batch(qs[:8], **kw)
        for q, want_hits in zip(qs[:8], batch):
            if [h["id"] for h in e8.search_embedded(q, **kw)] != [h["id"] for h in want_hits]:
                raise AssertionError(f"int8 per-query search_embedded differs from the batch: "
                                     f"{kw['mode']}")
    log("3k int8 per-query search_embedded (8 queries, tokens two_stage and single_tiles): "
        "same ids as the batch")

    for dt in dtypes:
        ok, ok_tol = strict_oracle(eng[dt], qs[:256], idx3k.num_docs)
        exact = eng[dt].search_embedded_batch(qs[:256], mode="single_full", top_k=10,
                                              with_payload=False)
        wide = eng[dt].search_embedded_batch(qs[:256], mode="two_stage", top_k=10,
                                             prefetch_k=idx3k.num_docs, with_payload=False, **tok)
        ok_tok = all(strict_rank_equal(ex, wd, score_tol=0.0) for ex, wd in zip(exact, wide))
        log(f"strict oracle 3k {dt} (256 queries): pooled {ok} (tol {ok_tol:g}), tokens {ok_tok} "
            "(tol 0)")
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
                search_pass(e, qs, 1024, f"100k {dt} {what}", **kw)
            search_pass(e, qs[:512], 256, f"100k {dt} single_full", mode="single_full")
            search_pass(e, qs, 1024, f"100k {dt} three_stage", mode="three_stage",
                        stage1_k=1000, stage2_k=300)
        else:
            search_pass(e, qs, 1024, f"100k {dt} pooled")
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


def pooled_stage1_phase(dev, card):
    """The pooled stage-1 kernel (``pooled_stage1_scores``, ``csrc/pooled_stage1.cu``)
    against its plain version, then timed. First bf16, f16 and int8 stores (int8
    with its scales) at P 32 x 3000 docs x 1030 queries, P 76 with holes x 64
    queries and P 10 x 1000 docs x 1 query: within ATOL, two calls bit-equal,
    docs with no valid row 0. Then the search cell's shape (1024 queries x
    200k docs, P 32 of which 28-32 valid, bf16) and one query on it: CUDA-event
    ms of the kernel and of the plain version, and the bound (the store read
    once, 2 * dim operations a query and valid pooled row). Not counted: the
    entry's launches are the engine's, phase 7."""
    import torch

    from visual_rag_tpu_torch.index.quantize import quantize_rows_int8
    from visual_rag_tpu_torch.ops.kernels.prefetch_topk import (
        pooled_stage1_scores,
        pooled_stage1_scores_ref,
    )

    fn, ref = pooled_stage1_scores, pooled_stage1_scores_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)

    def unit(*shape):
        return torch.nn.functional.normalize(
            torch.randn(shape, generator=gen, device=dev), dim=-1)

    err = 0.0
    for p, d, b in ((32, 3000, 1030), (76, 3000, 64), (10, 1000, 1)):
        v, q = unit(p, d, 128), unit(b, 128)
        m = torch.rand((p, d), generator=gen, device=dev) > 0.3
        m[:, [17, d - 1]] = False
        codes, scales = quantize_rows_int8(v)
        for what, args in (("bf16", (v.bfloat16(), m, q)), ("f16", (v.half(), m, q)),
                           ("int8", (codes, m, q, scales))):
            got, again, want = fn(*args), fn(*args), ref(*args)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=0, atol=ATOL):
                raise AssertionError(f"pooled_stage1_scores {what} P {p} B {b}: {e}")
            if not torch.equal(got, again) or not (got[:, ~m.any(dim=0)] == 0).all():
                raise AssertionError(f"pooled_stage1_scores {what} P {p} B {b}: not "
                                     "deterministic, or a doc with no valid row not 0")
            err = max(err, e)
    del v, q, m, codes, scales, got, again, want

    p, d, b = 32, 200000, 1024
    vals = torch.empty((p, d, 128), dtype=torch.bfloat16, device=dev)
    for s in range(0, d, 25000):
        vals[:, s:s + 25000] = unit(p, min(25000, d - s), 128).bfloat16()
    valid = torch.randint(28, 33, (d,), generator=gen, device=dev)
    mask = torch.arange(p, device=dev)[:, None] < valid[None, :]
    q = unit(b, 128)
    got, want = fn(vals, mask, q), ref(vals, mask, q)
    torch.cuda.synchronize()
    e = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=0, atol=ATOL):
        raise AssertionError(f"pooled_stage1_scores at the search cell's shape: {e}")
    del got, want
    ms, ms1 = cuda_ms(lambda: fn(vals, mask, q)), cuda_ms(lambda: fn(vals, mask, q[:1]))
    plain_ms, plain1 = (cuda_ms(lambda: ref(vals, mask, q), iters=2),
                        cuda_ms(lambda: ref(vals, mask, q[:1]), iters=2))
    nbytes = _nb(vals) + _nb(mask) + b * 128 * 4 + b * d * 4
    bound_ms, by = bound(nbytes, 2.0 * 128 * b * float(mask.sum()), "bf16")
    bound1, by1 = bound(nbytes - (b - 1) * (128 + d) * 4, 2.0 * 128 * float(mask.sum()), "bf16")
    log(f"pooled_stage1_scores [{b} x {d} docs, P {p} (28-32 valid), bf16]: max_abs_err "
        f"{max(err, e):.3g} kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms "
        f"({by}); 1 query: kernel {ms1:.4f} ms plain {plain1:.4f} ms bound {bound1:.4f} ms "
        f"({by1}) [{card}]")
    return {"name": "pooled_stage1_scores", "route": "cuda",
            "source": "visual_rag_tpu_torch/csrc/pooled_stage1.cu",
            "replaces": "none (XLA's fusion of visual_rag_tpu/parallel/sharded.py:341-351)",
            "max_abs_err": max(err, e), "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": by, "ms_1q": ms1, "plain_ms_1q": plain1,
            "bound_ms_1q": bound1}


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
        uses_mma,
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
            mma = name == "K3" and uses_mma(args[0].dtype, args[0].shape[1])
            before = k3.mma_launches
            got, again = fn(*args), fn(*args)
            torch.cuda.synchronize()
            if k3.mma_launches - before != (2 if mma else 0):
                raise AssertionError(f"{name} at {shape}: the tensor-core K3 launched "
                                     f"{k3.mma_launches - before} times, not {2 if mma else 0}")
            err = float((got - want).abs().max())
            diff = float((got - base).abs().max())
            if not torch.allclose(got, want, rtol=0, atol=ATOL):
                raise AssertionError(f"{name} disagrees with its plain version at {shape}: {err}")
            if not torch.equal(got, again):
                raise AssertionError(f"{name} is not deterministic at {shape}")
            if diff > (ATOL if mma else 0.0):  # K4 shares K2's row dots; K3's body its products
                raise AssertionError(f"{name} differs from K2 by {diff} at {shape}")
            times[name] = cuda_ms(lambda: fn(*args), iters)
            times[f"{name} plain"] = plain_ms
            s = summary[name]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            s["max_abs_diff_k2"] = max(s["max_abs_diff_k2"], diff)
            s["shapes"][shape] = {"ms": times[name], "plain_ms": plain_ms, "k2_ms": times["K2"],
                                  "max_abs_err": err, "max_abs_diff_k2": diff,
                                  **maxsim_bound("rerank", args)}
            notes.append(f"{name} max_abs_err {err:.3g}, "
                         + (f"max |K2 diff| {diff:.3g} (tensor cores)" if mma
                            else "bit-equal to K2"))
            del want, got, again
        log(f"K3/K4 [{shape}]: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
            + "; " + "; ".join(notes) + f" [{card}]")

    with uncounted(all_fns):
        q3k = quantize_index(idx3k, "int8")
        for store, index in (("3k bf16", idx3k), ("3k int8", q3k)):
            for n in (32, 256):
                hold(store, index, n, 10)
        del q3k
        # an f32 store keeps K3's CUDA-core body (maxsim_dedup.cu), bit-equal to K2
        f32 = synthetic_index(3000, min_tokens=320, max_tokens=832, pooled_rows=10,
                              storage_dtype="float32", seed=0, device=dev)
        hold("3k f32", f32, 256, 10)
        del f32
        torch.cuda.empty_cache()
        for dt in ("bfloat16", "int8"):
            index = synthetic_index(100000, min_tokens=128, max_tokens=256, pooled_rows=12,
                                    storage_dtype=dt, seed=2, device=dev)
            hold(f"100k {'bf16' if dt == 'bfloat16' else dt}", index, 1024, 5)
            del index
            torch.cuda.empty_cache()
        cell = k3_cell_shape(dev, card, k2, k3)
        torch.cuda.empty_cache()
    ptxas = {e: lines for e, lines in ptxas_report().items() if "dedup_kernel_mma" in e}
    for entry, lines in ptxas.items():
        log(f"ptxas {entry}: {'; '.join(lines)}")
        if not any("0 bytes spill stores, 0 bytes spill loads" in x for x in lines):
            raise AssertionError(f"K3's tensor-core instance {entry} spills: {lines}")
    if len(ptxas) != 3:
        raise AssertionError(f"the build log names {sorted(ptxas)}, not K3's 3 tensor-core "
                             "instances (bf16, f16, int8)")

    # 10b. the paths that route to K3 and K4, counts from 0
    for fn in all_fns:
        fn.launches = 0
        if hasattr(fn, "launches_qdot"):
            fn.launches_qdot = 0
    k3.mma_launches = 0

    def run(what, engine, plain_engine, bs, n, kernel, **kw):
        before = kernel.launches
        search_pass(engine, qs[:n], bs, what, **kw)
        launched = kernel.launches - before
        args = dict(BENCH_KW, return_arrays=True, **kw)
        got = engine.search_embedded_batch(qs[:bs], **args)
        want = plain_engine.search_embedded_batch(qs[:bs], **args)
        same = bool(np.array_equal(got.indices, want.indices))
        log(f"{what}: {kernel.__name__} launched {launched} times over {n} queries, ids == "
            f"rerank_impl='plain': {same}")
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
    log(f"strict oracle 3k padded wire (64 queries, prefetch_k = corpus): tol 0 {exact}, "
        f"tol 1e-4 {close}; {k4.__name__} launched {k4.launches - before} times")
    if not close:
        raise AssertionError("strict oracle failed on the padded wire (K4)")

    counts = {"K3": k3.launches, "K4": k4.launches}
    log(f"launches over phase 10's path: {counts}; of K3's, the tensor-core body's: "
        f"{k3.mma_launches}")
    if k3.mma_launches != k3.launches:  # bf16 and int8_refined stores at dim 128
        raise AssertionError("K3 ran its CUDA-core body on phase 10's path")
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
    out[0].update(source="visual_rag_tpu_torch/csrc/maxsim_dedup_mma.cu (bf16, f16, int8 at "
                  "dim 128; maxsim_dedup.cu otherwise)", mma_launches=k3.mma_launches,
                  cell_shape=cell, ptxas=ptxas)
    return out


def k3_cell_shape(dev, card, k2, k3):
    """K3 at the search cell's shape, not counted: 1024 queries of 12-32 valid
    rows (32 padded) x 200 candidates drawn uniformly over 200k docs of
    992-1024 rows in bf16 (fewer docs where the card's free memory, less 8
    GB, holds fewer): two calls bit-equal, within ATOL of K2 (the difference
    logged), the CUDA-event ms of K3 and K2 beside the bound."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    n_docs = int(min(200000, (torch.cuda.mem_get_info(dev)[0] - 8e9) // (1024 * 256)))
    lengths = torch.randint(992, 1025, (n_docs,), generator=gen, device=dev, dtype=torch.int32)
    offsets = torch.zeros_like(lengths)
    offsets[1:] = torch.cumsum(lengths, 0)[:-1].to(torch.int32)
    rows = int(lengths.sum())
    flat = torch.empty((rows, 128), dtype=torch.bfloat16, device=dev)
    for s in range(0, rows, 1 << 22):
        e = min(rows, s + (1 << 22))
        flat[s:e] = torch.nn.functional.normalize(
            torch.randn((e - s, 128), generator=gen, device=dev), dim=-1).bfloat16()
    b, nq, k = 1024, 32, 200
    tokens = torch.nn.functional.normalize(
        torch.randn((b, nq, 128), generator=gen, device=dev), dim=-1)
    valid = torch.randint(12, 33, (b,), generator=gen, device=dev)
    qmask = (torch.arange(nq, device=dev)[None, :] < valid[:, None]).float()
    cand = torch.randint(0, n_docs, (b, k), generator=gen, device=dev, dtype=torch.int32)
    args = (flat, offsets, lengths, tokens, qmask, cand, 1024)
    got, again, base = k3(*args), k3(*args), k2(*args)
    torch.cuda.synchronize()
    diff = float((got - base).abs().max())
    if not torch.equal(got, again) or not diff <= ATOL:
        raise AssertionError(f"K3 at the cell's shape: bit-equal twice {torch.equal(got, again)}, "
                             f"max |K2 diff| {diff}")
    ms, k2_ms = cuda_ms(lambda: k3(*args), 5), cuda_ms(lambda: k2(*args), 3)
    bnd = maxsim_bound("rerank", args)
    distinct = int(cand.unique().numel())
    log(f"K3 [1024 x 200 over {n_docs} docs of 992-1024 rows ({rows * 256 / 1e9:.2f} GB), bf16, "
        f"{distinct} distinct candidates]: {ms:.4f} ms (K2 {k2_ms:.4f} ms), bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), {100 * bnd['bound_ms'] / ms:.1f}% of it; "
        f"bit-equal twice, max |K2 diff| {diff:.3g} [{card}]")
    return {"docs": n_docs, "distinct": distinct, "ms": ms, "k2_ms": k2_ms,
            "max_abs_diff_k2": diff, **bnd}


def allowed_pair_count(seg, causal: bool) -> int:
    """Pairs (query i, key j) K10 computes on these segment ids: j in i's
    segment, and j <= i under causal (n(n + 1) / 2 for a segment of n)."""
    import torch

    total = 0
    for row in seg:
        n = torch.unique(row, return_counts=True)[1].long()
        total += int((n * (n + 1) // 2).sum() if causal else (n * n).sum())
    return total


def live_tile_pairs(seg, tile: int = 64) -> int:
    """(query tile, kv tile) pairs of one batch row that K10 computes without
    causal: those whose segment-id ranges meet (Dh 80's tiles are 64 rows
    and 64 keys, so a query tile's range is its own kv tile's)."""
    import torch

    pad = (-seg.shape[-1]) % tile
    tiles = torch.nn.functional.pad(seg, (0, pad), value=int(seg[-1])).view(-1, tile)
    lo, hi = tiles.amin(1), tiles.amax(1)
    return int(((lo[:, None] <= hi[None, :]) & (lo[None, :] <= hi[:, None])).sum())


def k10_shape(dev, card, name, dtype, b, t, hq, hkv, dh, seg, causal, iters):
    """K10 against its plain version at one shape (module docstring, 11a, 12a):
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
    q, k, v = (torch.randn((b, t, h, dh), generator=gen, device=dev).to(dtype)
               for h in (hq, hkv, hkv))
    got, again = (flash_attention(q, k, v, seg, causal=causal) for _ in range(2))
    want = flash_attention_plain(q, k, v, seg, causal=causal)
    torch.cuda.synchronize()
    diff, ref = (got.float() - want.float()).abs(), want.float().abs()
    err = float(diff.max())
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    rtol, atol = K10_TOL[dt]
    of_limit = float((diff / (atol + rtol * ref)).max())
    differ = float((diff > 0).float().mean())
    rms = float(ref.square().mean().sqrt())
    if not of_limit <= 1.0:
        raise AssertionError(f"K10 {name} {dtype}: |got - want| reaches {of_limit:.3g} of "
                             f"atol {atol} + rtol {rtol} |want| (max_abs_err {err})")
    del diff, ref
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
    bound_ms, bound_by = bound(nbytes, 4 * dh * pairs * hq, dt)
    log(f"K10 {name} {dt} [B {b}, T {t}, heads {hq}/{hkv}, Dh {dh}, "
        f"{'causal' if causal else 'segments'}, "
        f"{pairs} allowed pairs a head]: max_abs_err {err:.3g} (rms of want {rms:.3g}), "
        f"{of_limit:.3g} of the limit atol {atol} + rtol {rtol:.3g} |want|, {differ:.3g} of "
        f"the elements differ; bit-equal twice; "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms SDPA {library_ms:.4f} ms "
        f"bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    return {"max_abs_err": err, "of_limit": of_limit, "differ": differ, "rms_want": rms,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "pairs_per_head": pairs,
            "shape": [b, t, hq, hkv, dh], "causal": causal}


def prefix_seg(dev, lengths, t):
    """int32 [B, T] segment ids: 1 for the first lengths[b] rows, then pads (0)."""
    import torch

    return (torch.arange(t, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]
            ).to(torch.int32)


def k10_shapes(dev, card, shapes):
    """K10 against its plain version at each (b, t, hq, hkv, dh, seg,
    causal, iters) of ``shapes``, in bf16 and in f32."""
    import torch

    out = {}
    for name, (b, t, hq, hkv, dh, seg, causal, iters) in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            out[f"{name} {'bf16' if dtype == torch.bfloat16 else 'f32'}"] = k10_shape(
                dev, card, name, dtype, b, t, hq, hkv, dh, seg, causal, iters)
            torch.cuda.empty_cache()
    return out


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

    t_phase = time.perf_counter()
    log("bf16 GEMMs: torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}; allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")

    # 11a. K10 against its plain version at the path's three shapes (not counted)
    def tile_seg(b, n_tiles, t):
        seg = torch.zeros((b, t), dtype=torch.int32, device=dev)
        seg[:, :n_tiles * 1024] = torch.arange(n_tiles * 1024, device=dev) // 1024 + 1
        return seg

    rng = np.random.default_rng(11)
    q_lens = [int(x) for x in rng.integers(5, 31, 64)]
    shapes = {"vision 17 tiles": (1, 17408, 12, 12, 64, tile_seg(1, 17, 17408), False, 5),
              "page text 13 tiles": (4, 896, 15, 5, 64, prefix_seg(dev, [836] * 4, 896), True,
                                     10),
              "queries": (64, 30, 15, 5, 64, prefix_seg(dev, q_lens, 30), True, 10)}
    k10 = k10_shapes(dev, card, shapes)
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
    pages, infos = [], []
    for tiles, imgs in groups.items():
        e, i = emb.embed_images(imgs, return_token_info=True)
        pages += e
        infos += i
    qs = emb.embed_queries(texts, batch_size=64)
    k10_launches = flash_attention.launches
    want = 4 * (cfg.vision.layers + cfg.text.layers) + cfg.text.layers
    log(f"embedded 32 pages (8 each of 5, 9, 13, 17 tiles; batches of one geometry) and 64 "
        f"queries in one batch; K10 launched {k10_launches} times (4 page batches x "
        f"{cfg.vision.layers + cfg.text.layers} + 1 query batch x {cfg.text.layers} = {want})")
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

    builder = IndexBuilder(CollectionSchema.standard())
    for i, (e, info) in enumerate(zip(pages, infos)):
        vectors, payload = page_vectors(emb, e, info)
        builder.add(f"page{i}", vectors, dict(payload, tiles=info["num_tiles"]))
    index = builder.seal(device=dev)
    engine = RetrievalEngine(index)
    kw = dict(mode="two_stage", top_k=10, prefetch_k=200, with_payload=False)
    hits = engine.search_embedded_batch(qs, **kw)
    # bs 64 on 32 docs reranks by the scan (K1, the policy's pick when the
    # candidates cover the corpus); bs 16 by K2; the tokens stage-1 by K5 / K6
    hits += engine.search_embedded_batch(qs, **kw, stage1_mode=TOKENS)
    for stage1 in ("pooled_query_vs_standard_pooling", TOKENS):
        hits += engine.search_embedded_batch(qs[:16], **kw, stage1_mode=stage1)
    if not all(len(h) == 10 and all(np.isfinite(x["score_final"]) for x in h) for h in hits):
        raise AssertionError("a search over the embedded pages did not answer 10 hits")
    oracle, oracle_tol = strict_oracle(engine, qs, index.num_docs)
    counts = {fn.__name__: fn.launches for fn in counters}
    log(f"ingest: 32 pages -> page_vectors -> IndexBuilder.seal (bf16, {index.nbytes()} "
        f"bytes); two_stage (prefetch_k 200, top_k 10) of the 64 embedded queries, then with "
        f"the tokens stage-1, and both at bs 16; strict oracle (prefetch_k = corpus vs "
        f"single_full, tol {oracle_tol:g}): {oracle}; launches over the main path: {counts}")
    if not oracle:
        raise AssertionError("strict oracle failed on the embedded corpus")
    for what, fns in (("K2", rerank_fns[:1]), ("the scan", search_fns[:1]),
                      ("a tokens stage-1 kernel", search_fns[1:])):
        if sum(fn.launches for fn in fns) <= 0:
            raise AssertionError(f"the search over the embedded pages never launched {what}")

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


def colpali_pages(n_pages: int, seed: int):
    """n_pages random RGB pages (f32 in [0, 1]) in four aspect ratios: A4
    and letter portrait, letter landscape, a square scan (ColPali resizes
    each to its 32 x 32 patch grid)."""
    rng = np.random.default_rng(seed)
    sizes = ((1170, 827), (1100, 850), (850, 1100), (900, 900))
    return [rng.random(sizes[i % 4] + (3,), dtype=np.float32) for i in range(n_pages)]


def colpali_phase(dev, card, rerank_fns, search_fns):
    """Phase 12: the ColPali-v1.3 embedding path (module docstring).
    ``rerank_fns`` are K2, K3 and K4, ``search_fns`` the scan and the
    tokens stage-1 entry points. Returns K10's shapes and launches here."""
    import dataclasses

    import torch

    from visual_rag_tpu_torch import CollectionSchema, IndexBuilder, RetrievalEngine
    from visual_rag_tpu_torch.models.colvlm import ColVLM
    from visual_rag_tpu_torch.models.convert import build_model
    from visual_rag_tpu_torch.models.embedder import VisualEmbedder
    from visual_rag_tpu_torch.ops.kernels.flash_attention import flash_attention
    from visual_rag_tpu_torch.pipeline.vectors import experimental_vector_plan, page_vectors

    t_phase = time.perf_counter()
    # 12a. K10 against its plain version at the path's three shapes (not counted):
    # a page's 32 x 32 patches through SigLIP (16 heads of 72, no pads); 4 pages'
    # text, 1024 image tokens + a 4-token prompt in T = 1088 (8 heads of 256 on
    # one kv head, bidirectional); 64 queries of 6-30 tokens
    rng = np.random.default_rng(12)
    q_lens = [int(x) for x in rng.integers(6, 31, 64)]
    shapes = {
        "colpali vision 1 page": (1, 1024, 16, 16, 72, prefix_seg(dev, [1024], 1024), False,
                                  10),
        "colpali page text 4 pages": (4, 1088, 8, 1, 256, prefix_seg(dev, [1028] * 4, 1088),
                                      False, 10),
        "colpali queries": (64, 32, 8, 1, 256, prefix_seg(dev, q_lens, 32), False, 10)}
    k10 = k10_shapes(dev, card, shapes)

    # 12b. full-width ColPali-v1.3 in bf16, random weights from seed 0 drawn on the card
    t0 = time.perf_counter()
    emb = VisualEmbedder("vidore/colpali-v1.3", batch_size=8, seed=0, device=dev)
    cfg = emb.cfg
    n_params = sum(p.numel() for p in emb.model.parameters())
    torch.cuda.synchronize()
    log(f"ColPali-v1.3 (vision {cfg.vision.layers} x {cfg.vision.hidden}, heads of "
        f"{cfg.vision.hidden // cfg.vision.heads}; text {cfg.text.layers} x {cfg.text.hidden}, "
        f"{cfg.text.heads} heads of {cfg.text.hidden // cfg.text.heads} on {cfg.text.kv_heads} "
        f"kv head; {n_params} parameters, {cfg.dtype}) on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    if n_params != COLPALI_PARAMS:
        raise AssertionError(f"ColPali-v1.3 has {n_params} parameters, not {COLPALI_PARAMS}")
    pages = colpali_pages(32, seed=200)
    texts = synthetic_queries(64, seed=13)
    emb.embed_images(pages[:8])  # warm batch, not counted
    emb.embed_queries(texts[:8], batch_size=64)
    torch.cuda.synchronize()
    counters = (flash_attention,) + tuple(rerank_fns) + tuple(search_fns)
    for fn in counters:
        fn.launches = 0

    # -- the main path: embed pages and queries, pool, seal, search --
    embs, infos = emb.embed_images(pages, batch_size=8, return_token_info=True)
    qs = emb.embed_queries(texts, batch_size=64)
    k10_launches = flash_attention.launches
    want = 4 * (cfg.vision.layers + cfg.text.layers) + cfg.text.layers
    log(f"embedded 32 pages (4 aspect ratios, batches of 8) and 64 queries in one batch; K10 "
        f"launched {k10_launches} times (4 page batches x {cfg.vision.layers + cfg.text.layers} "
        f"+ 1 query batch x {cfg.text.layers} = {want})")
    if k10_launches != want:
        raise AssertionError(f"K10 launched {k10_launches} times on ColPali's path, not {want}")
    for e, info in zip(embs, infos):
        if e.shape != (info["num_visual_tokens"] + 4, 128) or not np.isfinite(e).all():
            raise AssertionError(f"a ColPali page embedding is {e.shape} or not finite")
        if not np.allclose(np.linalg.norm(e, axis=1), 1.0, atol=1e-3):
            raise AssertionError("ColPali page token embeddings are not unit vectors")
    if not all(np.isfinite(x).all() and x.shape[1] == 128 and x.shape[0] > 0 for x in qs):
        raise AssertionError("a ColPali query embedding is not finite or has the wrong shape")

    plan = experimental_vector_plan(emb.backend)
    builder = IndexBuilder(CollectionSchema.standard(experimental_names=plan["names"]))
    for i, (e, info) in enumerate(zip(embs, infos)):
        builder.add(f"page{i}", *page_vectors(emb, e, info))
    index = builder.seal(device=dev)
    engine = RetrievalEngine(index, stage1_cut="exact")
    rows = {n: tuple(index.store(n).values.shape[:2]) for n in plan["names"]}
    kw = dict(mode="two_stage", top_k=10, prefetch_k=200, with_payload=False)
    hits = []
    for stage1 in ("pooled_query_vs_standard_pooling", TOKENS):
        hits += engine.search_embedded_batch(qs, **kw, stage1_mode=stage1)  # bs 64: the scan
        hits += engine.search_embedded_batch(qs[:16], **kw, stage1_mode=stage1)  # bs 16: K2
    if not all(len(h) == 10 and all(np.isfinite(x["score_final"]) for x in h) for h in hits):
        raise AssertionError("a search over the ColPali pages did not answer 10 hits")
    oracle, oracle_tol = strict_oracle(engine, qs, index.num_docs)
    counts = {fn.__name__: fn.launches for fn in counters}
    log(f"ingest: 32 ColPali pages -> page_vectors ({plan['names']}, {rows}) -> "
        f"IndexBuilder.seal (bf16, {index.nbytes()} bytes); "
        f"RetrievalEngine(stage1_cut='exact'): two_stage (prefetch_k 200, top_k 10), pooled "
        f"and tokens stage-1, bs 64 and 16; strict oracle (prefetch_k = corpus vs single_full, "
        f"tol {oracle_tol:g}): {oracle}; launches over the main path: {counts}")
    if not oracle:
        raise AssertionError("strict oracle failed on the ColPali corpus")
    for what, fns in (("a rerank kernel", tuple(rerank_fns) + search_fns[:1]),
                      ("a tokens stage-1 kernel", search_fns[1:])):
        if sum(fn.launches for fn in fns) <= 0:
            raise AssertionError(f"the search over the ColPali pages never launched {what}")

    # 12c. the whole-model yardstick: the same weights with the dense attention
    dense = VisualEmbedder("vidore/colpali-v1.3", batch_size=8, params=emb.params, device=dev)
    dense.model.use_flash = False
    for what, a, b in (("2 pages", emb.embed_images(pages[:2]), dense.embed_images(pages[:2])),
                       ("16 queries", emb.embed_queries(texts[:16], batch_size=16),
                        dense.embed_queries(texts[:16], batch_size=16))):
        cos = min(float((x * y).sum(axis=1).min()) for x, y in zip(a, b))
        diff = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
        log(f"ColPali yardstick ({what}): K10 path vs use_flash=False (dense), the same bf16 "
            f"weights: min per-token cosine {cos:.6f}, max abs diff {diff:.3g}")
        if cos < 0.99:
            raise AssertionError(f"K10 path and dense attention disagree on ColPali {what}: {cos}")
    del dense

    # 12d. card against CPU in f32, at full width and a depth cut to 2 + 2 layers
    # (a full f32 ColPali is 11.8 GB on each side)
    cut = dataclasses.replace(cfg, dtype="float32",
                              vision=dataclasses.replace(cfg.vision, layers=2),
                              text=dataclasses.replace(cfg.text, layers=2))
    keep = set(ColVLM(cut, device="meta").state_dict())
    sd32 = {k: v.float().cpu() for k, v in emb.params.items() if k in keep}
    ids, mask = emb.processor.process_queries(texts[:4])
    proc = emb.processor.process_images(pages[:1])
    outs = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        model = build_model(cut, sd32, d)
        with torch.inference_mode():
            outs[where] = (
                model.embed_queries(torch.from_numpy(ids).to(d), torch.from_numpy(mask).to(d)),
                model.embed_pages(*(torch.from_numpy(x).to(d) for x in (
                    proc.input_ids, proc.attn_mask, proc.patches, proc.patch_mask))))
            outs[where] = tuple(x.cpu() for x in outs[where])
        del model
    err32 = max(float((a - b).abs().max()) for a, b in zip(outs["card"], outs["cpu"]))
    log(f"card vs CPU, ColPali-v1.3 in f32 at full width cut to 2 vision + 2 text layers, 4 "
        f"queries and 1 page: max abs diff {err32:.3g} (atol 1e-3)")
    if err32 > 1e-3:
        raise AssertionError(f"the f32 ColPali on the card and on the CPU differ by {err32}")
    del emb, sd32, outs, engine, index
    torch.cuda.empty_cache()
    log(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return {"shapes": k10, "launches": k10_launches}


def colqwen_phase(dev, card, rerank_fns, search_fns):
    """Phase 13: the ColQwen2.5-v0.2 embedding path (module docstring).
    ``rerank_fns`` are K2, K3 and K4, ``search_fns`` the scan and the
    tokens stage-1 entry points. Returns K10's shapes and launches here."""
    import dataclasses

    import torch

    from visual_rag_tpu_torch import CollectionSchema, IndexBuilder, RetrievalEngine
    from visual_rag_tpu_torch.models.attention import segment_ids
    from visual_rag_tpu_torch.models.colvlm import ColVLM
    from visual_rag_tpu_torch.models.convert import build_model
    from visual_rag_tpu_torch.models.embedder import VisualEmbedder
    from visual_rag_tpu_torch.ops.kernels.flash_attention import flash_attention
    from visual_rag_tpu_torch.pipeline.vectors import experimental_vector_plan, page_vectors

    t_phase = time.perf_counter()
    # 13a. K10 against its plain version at the path's four shapes (not counted)
    emb = VisualEmbedder("vidore/colqwen2.5-v0.2", batch_size=8, seed=0, device=dev)
    cfg = emb.cfg
    pages = colpali_pages(32, seed=300)
    one = emb.processor.process_images(pages[:1])  # A4 portrait: 74 x 54 patches
    valid = torch.from_numpy(one.patch_mask).to(dev)
    window = segment_ids(valid, torch.from_numpy(one.window_ids).to(dev))
    text = emb.processor.process_images([pages[i] for i in (0, 1, 2, 4)])  # T 1024
    t_text = text.attn_mask.shape[1]
    ids, qmask = emb.processor.process_queries(synthetic_queries(64, seed=14))
    heads, dv = cfg.vision.heads, cfg.vision.hidden // cfg.vision.heads
    th, tkv, dt = cfg.text.heads, cfg.text.kv_heads, cfg.text.hidden // cfg.text.heads
    n_patches = one.patch_mask.shape[1]
    shapes = {
        "colqwen vision window 1 page": (1, n_patches, heads, heads, dv, window, False, 10),
        "colqwen vision full 1 page": (1, n_patches, heads, heads, dv, valid.to(torch.int32),
                                       False, 5),
        "colqwen page text 4 pages": (4, t_text, th, tkv, dt,
                                      prefix_seg(dev, text.attn_mask.sum(1).tolist(), t_text),
                                      True, 10),
        "colqwen queries": (64, ids.shape[1], th, tkv, dt,
                            prefix_seg(dev, qmask.sum(1).tolist(), ids.shape[1]), True, 10)}
    k10 = k10_shapes(dev, card, shapes)
    live = live_tile_pairs(window[0])
    log(f"ColQwen window layer, one A4 page: K10 computes {live} of "
        f"{(n_patches // 64) ** 2} (query tile, kv tile) pairs a head, "
        f"{live * 64 * 64} key pairs against {allowed_pair_count(window, False)} allowed")
    k10["colqwen vision window 1 page bf16"]["live_tile_pairs"] = live
    ptxas = {entry: lines for entry, lines in ptxas_report().items()
             if serving_instance(entry) and ("Li80E" in entry or "Li128E" in entry)}
    if len(ptxas) != 4:  # Dh 80 and 128, f32 and bf16
        raise AssertionError(f"the build log names {len(ptxas)} K10 instances at Dh 80 and "
                             f"128, not 4: {sorted(ptxas)}")
    for entry, lines in ptxas.items():
        log(f"ptxas {entry}: {'; '.join(lines)}")
        if not any("0 bytes spill stores, 0 bytes spill loads" in x for x in lines):
            raise AssertionError(f"K10 instance {entry} spills: {lines}")
    del window, valid

    # 13b. full-width ColQwen2.5-v0.2 in bf16, random weights from seed 0 drawn on the card
    t0 = time.perf_counter()
    n_params = sum(p.numel() for p in emb.model.parameters())
    torch.cuda.synchronize()
    log(f"ColQwen2.5-v0.2 (vision {cfg.vision.layers} x {cfg.vision.hidden}, {heads} heads of "
        f"{dv}, full attention in layers {cfg.vision.full_attn_layers}; merger "
        f"{cfg.spatial_merge} x {cfg.spatial_merge}; text {cfg.text.layers} x "
        f"{cfg.text.hidden}, {th} heads of {dt} on {tkv} kv heads, M-RoPE "
        f"{cfg.text.mrope_section}; {n_params} parameters, {cfg.dtype}) on the card in "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
    if n_params != 3963137408:
        raise AssertionError(f"ColQwen2.5-v0.2 has {n_params} parameters, not 3963137408")
    texts = synthetic_queries(64, seed=15)
    emb.embed_images(pages[:8])  # warm batch, not counted
    emb.embed_queries(texts[:8], batch_size=64)
    torch.cuda.synchronize()
    counters = (flash_attention,) + tuple(rerank_fns) + tuple(search_fns)
    for fn in counters:
        fn.launches = 0

    # -- the main path: embed pages and queries, pool, seal, search --
    embs, infos = emb.embed_images(pages, batch_size=8, return_token_info=True)
    qs = emb.embed_queries(texts, batch_size=64)
    k10_launches = flash_attention.launches
    want = 4 * (cfg.vision.layers + cfg.text.layers) + cfg.text.layers
    grids = sorted({(i["grid_h_eff"], i["grid_w_eff"]) for i in infos})
    log(f"embedded 32 pages (4 aspect ratios, merged grids {grids}, 4096 patches a page in "
        f"the tower; batches of 8) and 64 queries in one batch; K10 launched {k10_launches} "
        f"times (4 page batches x {cfg.vision.layers + cfg.text.layers} + 1 query batch x "
        f"{cfg.text.layers} = {want})")
    if k10_launches != want:
        raise AssertionError(f"K10 launched {k10_launches} times on ColQwen's path, not {want}")
    for e, info in zip(embs, infos):
        n = info["grid_h_eff"] * info["grid_w_eff"]
        if e.shape != (n + 4, 128) or not np.isfinite(e).all():
            raise AssertionError(f"a ColQwen page embedding is {e.shape} or not finite")
        if not np.allclose(np.linalg.norm(e, axis=1), 1.0, atol=1e-3):
            raise AssertionError("ColQwen page token embeddings are not unit vectors")
    if not all(np.isfinite(x).all() and x.shape[1] == 128 and x.shape[0] > 0 for x in qs):
        raise AssertionError("a ColQwen query embedding is not finite or has the wrong shape")

    plan = experimental_vector_plan(emb.backend)
    builder = IndexBuilder(CollectionSchema.standard(experimental_names=plan["names"]))
    for i, (e, info) in enumerate(zip(embs, infos)):
        builder.add(f"page{i}", *page_vectors(emb, e, info))
    index = builder.seal(device=dev)
    engine = RetrievalEngine(index, stage1_cut="exact")
    rows = {n: tuple(index.store(n).values.shape[:2]) for n in plan["names"]}
    kw = dict(mode="two_stage", top_k=10, prefetch_k=200, with_payload=False)
    hits = []
    for stage1 in ("pooled_query_vs_standard_pooling", TOKENS):
        hits += engine.search_embedded_batch(qs, **kw, stage1_mode=stage1)  # bs 64: the scan
        hits += engine.search_embedded_batch(qs[:16], **kw, stage1_mode=stage1)  # bs 16: K2
    if not all(len(h) == 10 and all(np.isfinite(x["score_final"]) for x in h) for h in hits):
        raise AssertionError("a search over the ColQwen pages did not answer 10 hits")
    oracle, oracle_tol = strict_oracle(engine, qs, index.num_docs)
    counts = {fn.__name__: fn.launches for fn in counters}
    log(f"ingest: 32 ColQwen pages -> page_vectors ({plan['names']}, {rows}) -> "
        f"IndexBuilder.seal (bf16, {index.nbytes()} bytes); "
        f"RetrievalEngine(stage1_cut='exact'): two_stage (prefetch_k 200, top_k 10), pooled "
        f"and tokens stage-1, bs 64 and 16; strict oracle (prefetch_k = corpus vs single_full, "
        f"tol {oracle_tol:g}): {oracle}; launches over the main path: {counts}")
    if not oracle:
        raise AssertionError("strict oracle failed on the ColQwen corpus")
    for what, fns in (("a rerank kernel", tuple(rerank_fns) + search_fns[:1]),
                      ("a tokens stage-1 kernel", search_fns[1:])):
        if sum(fn.launches for fn in fns) <= 0:
            raise AssertionError(f"the search over the ColQwen pages never launched {what}")

    # 13c. the whole-model yardstick: the same weights with the dense attention
    dense = VisualEmbedder("vidore/colqwen2.5-v0.2", batch_size=8, params=emb.params,
                           device=dev)
    dense.model.use_flash = False
    for what, a, b in (("2 pages", emb.embed_images(pages[:2]), dense.embed_images(pages[:2])),
                       ("16 queries", emb.embed_queries(texts[:16], batch_size=16),
                        dense.embed_queries(texts[:16], batch_size=16))):
        cos = min(float((x * y).sum(axis=1).min()) for x, y in zip(a, b))
        diff = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
        log(f"ColQwen yardstick ({what}): K10 path vs use_flash=False (dense), the same bf16 "
            f"weights: min per-token cosine {cos:.6f}, max abs diff {diff:.3g}")
        if cos < 0.99:
            raise AssertionError(f"K10 path and dense attention disagree on ColQwen {what}: {cos}")
    del dense
    torch.cuda.empty_cache()

    # 13d. card against CPU in f32, at full width and a depth cut to 2 + 2 layers (the
    # second vision layer full attention, as layer 7 of the full tower)
    cut = dataclasses.replace(cfg, dtype="float32",
                              vision=dataclasses.replace(cfg.vision, layers=2,
                                                         full_attn_layers=(1,)),
                              text=dataclasses.replace(cfg.text, layers=2))
    keep = set(ColVLM(cut, device="meta").state_dict())
    sd32 = {k: v.float().cpu() for k, v in emb.params.items() if k in keep}
    ids, mask = emb.processor.process_queries(texts[:4])
    proc = emb.processor.process_images(pages[:1])
    outs = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        model = build_model(cut, sd32, d)
        with torch.inference_mode():
            outs[where] = (
                model.embed_queries(torch.from_numpy(ids).to(d), torch.from_numpy(mask).to(d)),
                model.embed_pages(*(torch.from_numpy(x).to(d) for x in (
                    proc.input_ids, proc.attn_mask, proc.patches, proc.patch_mask,
                    proc.window_ids, proc.patch_positions))))
            outs[where] = tuple(x.cpu() for x in outs[where])
        del model
    err32 = max(float((a - b).abs().max()) for a, b in zip(outs["card"], outs["cpu"]))
    log(f"card vs CPU, ColQwen2.5-v0.2 in f32 at full width cut to 2 vision (1 window, 1 full) "
        f"+ 2 text layers, 4 queries and 1 page: max abs diff {err32:.3g} (atol 1e-3)")
    if err32 > 1e-3:
        raise AssertionError(f"the f32 ColQwen on the card and on the CPU differ by {err32}")
    del emb, sd32, outs, engine, index
    torch.cuda.empty_cache()
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return {"shapes": k10, "launches": k10_launches}


# (rtol, atol as a share of the tensor's largest |want|) for B4 and B5 against their plain
# versions, each element: f32 sums of the same products in another order; in bf16 both
# round f32 values to bf16, so one output ulp (2**-7 |want|) apart
BWD_TOL = {"f32": (0.0, 1e-4), "bf16": (2.0 ** -7, 1e-5)}
# the forward that saves lse against its plain version: out within K10_TOL, and lse (f32
# m + log(l) of f32 logits in both, whatever the input dtype) within an absolute 1e-5,
# -inf in the same rows
LSE_ATOL = 1e-5
# a gradient leaf at most this share of the largest leaf is at f32 rounding level (phase
# 14c): the key biases read about 2e-9 of it on the CPU, every other leaf 2.8e-3 or more
ROUNDING_SHARE = 1e-6
COLPALI_PARAMS = 2943532928  # ColPali-v1.3 (PaliGemma-3B), as the flax init counts them
# the CLI's batches in phase 15, tried in order until one fits on the card without remat:
# 4 pairs fit when this process holds next to nothing; beside 11 GiB held here, only 2 did
CLI_BATCHES = (4, 2)


def serving_instance(entry: str) -> bool:
    """Whether a mangled kernel name is one of K10's serving instances (f32 on
    the CUDA cores, bf16 on the tensor cores)."""
    return "flash_fwd_kernel" in entry or "flash_fwd_mma_kernel" in entry


def training_ptxas(head_dims) -> dict:
    """The build log's ptxas lines of the flash instances at ``head_dims``
    (K10's serving forward and the forward that saves lse, B4 and B5; in f32,
    and in bf16 on the tensor cores) and of B4's reduction of a split head
    group, logged; each must spill 0 bytes."""
    names = ("flash_bwd_dkv", "flash_bwd_dq", "flash_fwd_")
    ptxas = {entry: lines for entry, lines in ptxas_report().items()
             if any(k in entry for k in names)
             and ("flash_bwd_dkv_reduce" in entry or any(f"Li{d}E" in entry for d in head_dims))}
    if len(ptxas) != 8 * len(head_dims) + 1:
        raise AssertionError(f"the build log names {len(ptxas)} flash kernel instances at "
                             f"head dims {head_dims} and the reduction, not "
                             f"{8 * len(head_dims) + 1}: {sorted(ptxas)}")
    for entry, lines in ptxas.items():
        log(f"ptxas {entry}: {'; '.join(lines)}")
        if not any("0 bytes spill stores, 0 bytes spill loads" in x for x in lines):
            raise AssertionError(f"flash kernel instance {entry} spills: {lines}")
    return ptxas


def flash_tensor_cores() -> dict:
    """{K10 / B4 / B5 instance: its HMMA instructions} in the built library's
    SASS (``cuobjdump -sass``), logged: each of the twenty bf16 instances (K10's
    serving forward and the forward that saves lse, B4 and B5, at five head
    dims each) must issue some (``mma.sync`` on the tensor cores), the twenty
    f32 instances none."""
    from visual_rag_tpu_torch.ops.kernels import _build
    from visual_rag_tpu_torch.tools.sass_diff import library_sass

    hmma = {name: sum("HMMA" in x for x in code)
            for name, code in library_sass(_build.library_path()).items()
            if "flash_fwd_" in name or "flash_bwd_dkv_" in name and "reduce" not in name
            or "flash_bwd_dq_" in name}
    bf16 = {n: c for n, c in hmma.items() if "_mma_kernel" in n}
    log("HMMA instructions in the SASS of K10, B4 and B5: "
        + ", ".join(f"{n} {c}" for n, c in sorted(hmma.items())))
    if len(hmma) != 40 or len(bf16) != 20 or not all(bf16.values()) or any(
            c for n, c in hmma.items() if n not in bf16):
        raise AssertionError(f"the flash kernels' bf16 instances must issue HMMA and the f32 "
                             f"ones none: {hmma}")
    return hmma


def card_vs_cpu_step(dev, cut, batch, what: str) -> None:
    """One step's loss and gradients of ``cut`` (f32, depth cut) from seed-0
    weights on the card against the CPU (phases 14c and 15c): the loss within
    1e-4 relative; each gradient leaf within 1e-3 of its own largest |CPU
    gradient|, except the leaves at f32 rounding level (``ROUNDING_SHARE``)."""
    import torch

    from visual_rag_tpu_torch.models.convert import init_params
    from visual_rag_tpu_torch.models.train import Trainer

    sd = {k: v.cpu() for k, v in init_params(cut, seed=0, device=dev,
                                             param_dtype=torch.float32).items()}
    res = {}
    for where in ("card", "cpu"):
        tr = Trainer(cut, lr=1e-4, warmup=0, device=dev if where == "card" else "cpu")
        st = tr.init_state(params=sd)
        (loss, _), grads = tr.value_and_grad(st.params, batch)
        res[where] = (float(loss), {k: g.cpu() for k, g in grads.items()})
        del tr, st, grads
    # each leaf within 1e-3 of its own largest |CPU gradient|, except the leaves whose CPU
    # gradient is at f32 rounding level, at most ROUNDING_SHARE of the largest of all leaves:
    # the key biases, whose exact gradient is 0 (a shift of every logit of a row leaves its
    # softmax as it is), so both devices give noise there. The rule may exempt only those,
    # and their card gradient must be at that level too
    loss_err = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    top = max(float(g.abs().max()) for g in res["cpu"][1].values())
    exempt = {k: (float(g.abs().max()), float(res["card"][1][k].abs().max()))
              for k, g in res["cpu"][1].items() if float(g.abs().max()) <= ROUNDING_SHARE * top}
    worst = max((float((res["card"][1][k] - g).abs().max()) / (1e-3 * float(g.abs().max())), k)
                for k, g in res["cpu"][1].items() if k not in exempt)
    log(f"card vs CPU, f32 at full width cut to {cut.vision.layers} + {cut.text.layers} layers, "
        f"one step's loss and gradients on {what}: loss {res['card'][0]:.6f} vs "
        f"{res['cpu'][0]:.6f} (relative {loss_err:.3g}, limit 1e-4); worst leaf {worst[1]} at "
        f"{worst[0]:.3g} of its limit (1e-3 of its largest); at rounding level (<= "
        f"{ROUNDING_SHARE} of the largest gradient, {top:.3g}), so exempt: "
        + ", ".join(f"{k} largest {c:.3g} on the CPU, {g:.3g} on the card" for k, (c, g) in
                    exempt.items()))
    if loss_err > 1e-4 or worst[0] > 1.0:
        raise AssertionError(f"f32 training on the card and on the CPU differ: {loss_err}, "
                             f"{worst}")
    if (not all(k.endswith("attn.k.bias") for k in exempt)
            or not all(g <= ROUNDING_SHARE * top for _, g in exempt.values())):
        raise AssertionError(f"the rounding-level rule exempts other leaves than the key "
                             f"biases, or the card's are not at that level: {exempt}")
    del res, sd
    torch.cuda.empty_cache()


def bwd_shape(dev, card, name, dtype, b, t, hq, hkv, dh, seg, causal, iters):
    """K10's forward that saves lse, B4 and B5 against their plain versions
    at one shape (module docstring, 14a). The forward: out within ``K10_TOL``
    and lse within ``LSE_ATOL``, two calls bit-equal, out equal to the serving
    forward's. B4 and B5, called directly and through the autograd Function's
    backward with a random dO: each of dq, dk, dv within ``BWD_TOL``, two calls
    bit-equal. The CUDA-event ms of each kernel, of its plain version and of
    SDPA (its forward on inputs that need grad, which keeps its logsumexp;
    its backward timed alone, with the same boolean mask); bound_ms of each
    kernel. Returns the three kernels' entries for this shape."""
    import torch
    import torch.nn.functional as F

    from visual_rag_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=dev)
    gen.manual_seed(t + hq + 1)
    q, do = (torch.randn((b, t, hq, dh), generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, t, hkv, dh), generator=gen, device=dev).to(dtype) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v, seg, causal=causal)
    out2, lse2 = fa.flash_attention_fwd(q, k, v, seg, causal=causal)
    serving = fa.flash_attention(q, k, v, seg, causal=causal)
    out_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, seg, causal=causal)
    torch.cuda.synchronize()
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    rtol, atol = K10_TOL[dt]
    diff = (out.float() - out_p.float()).abs()
    out_of_limit = float((diff / (atol + rtol * out_p.float().abs())).max())
    out_err = float(diff.max())
    del diff
    inf_same = torch.equal(torch.isinf(lse), torch.isinf(lse_p))
    fin = torch.isfinite(lse_p)
    lse_err = float((lse - lse_p).abs()[fin].max()) if bool(fin.any()) else 0.0
    n_inf = int((~fin).sum())
    if not out_of_limit <= 1.0 or not inf_same or not lse_err <= LSE_ATOL:
        raise AssertionError(f"K10 with lse {name} {dt}: out at {out_of_limit:.3g} of K10_TOL "
                             f"(max_abs_err {out_err}), lse max_abs_err {lse_err} (limit "
                             f"{LSE_ATOL}), -inf rows the same: {inf_same}")
    if not (torch.equal(out, out2) and torch.equal(lse, lse2) and torch.equal(out, serving)):
        raise AssertionError(f"K10 with lse {name} {dt} is not deterministic or its out differs "
                             "from the serving forward's")
    del out2, lse2, serving, out_p, lse_p, fin
    di = fa.attention_di(out, do)
    kw = dict(causal=causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, do, lse, di, **kw)
    dq = fa.flash_attention_bwd_dq(q, k, v, seg, do, lse, di, **kw)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, seg, do, lse, di, **kw)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, seg, do, lse, di, **kw)
    want = dict(zip(("dk", "dv"), fa.flash_attention_bwd_dkv_plain(q, k, v, seg, do, lse, di,
                                                                   **kw)))
    want["dq"] = fa.flash_attention_bwd_dq_plain(q, k, v, seg, do, lse, di, **kw)
    # through the Function: forward with lse, di, then B4 and B5
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    fa.flash_attention(qg, kg, vg, seg, causal=causal).backward(do)
    torch.cuda.synchronize()
    rtol, atol = BWD_TOL[dt]
    res = {}
    for key, got, again, via in (("dq", dq, dq2, qg.grad), ("dk", dk, dk2, kg.grad),
                                 ("dv", dv, dv2, vg.grad)):
        w = want[key].float()
        diff = (got.float() - w).abs()
        of_limit = float((diff / (atol * float(w.abs().max()) + rtol * w.abs())).max())
        res[key] = {"max_abs_err": float(diff.max()), "max_want": float(w.abs().max()),
                    "of_limit": of_limit}
        if not of_limit <= 1.0:
            raise AssertionError(f"B4/B5 {name} {dt} {key}: |got - want| reaches {of_limit:.3g} "
                                 f"of the limit (max_abs_err {float(diff.max())})")
        if not torch.equal(got, again):
            raise AssertionError(f"B4/B5 {name} {dt} {key} is not deterministic")
        if not torch.equal(got, via):
            raise AssertionError(f"B4/B5 {name} {dt} {key}: the Function's backward differs "
                                 "from the direct call")
    del want, dq2, dk2, dv2, qg, kg, vg
    fwd_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, seg, **kw), iters)
    fwd_plain = cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, seg, **kw), 1)
    b4_ms = cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, seg, do, lse, di, **kw), iters)
    b5_ms = cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, seg, do, lse, di, **kw), iters)
    b4_plain = cuda_ms(lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, seg, do, lse, di, **kw),
                       1)
    b5_plain = cuda_ms(lambda: fa.flash_attention_bwd_dq_plain(q, k, v, seg, do, lse, di, **kw),
                       1)
    rep = hq // hkv  # SDPA's backward alone: the forward made once, untimed
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (
        q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)))
    mask = torch.stack([fa.allowed_pairs(s, causal) for s in seg])[:, None]
    sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                          iters)
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    do_t = do.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), do_t,
                                                     retain_graph=True), iters)
    del qt, kt, vt, mask, o_sdpa
    pairs = allowed_pair_count(seg, causal)
    ins = sum(_nb(x) for x in (q, k, v, do, lse, di, seg))
    b4_bound = bound(ins + _nb(dk) + _nb(dv), 8 * dh * pairs * hq, dt)
    b5_bound = bound(ins + _nb(dq), 6 * dh * pairs * hq, dt)
    fwd_bound = bound(sum(_nb(x) for x in (q, k, v, seg, out, lse)), 4 * dh * pairs * hq, dt)
    log(f"K10 with lse {name} {dt} [B {b}, T {t}, heads {hq}/{hkv}, Dh {dh}, "
        f"{'causal' if causal else 'segments'}]: out max_abs_err {out_err:.3g} "
        f"({out_of_limit:.3g} of K10_TOL), lse max_abs_err {lse_err:.3g} (limit {LSE_ATOL}; "
        f"{n_inf} -inf rows, the same in both); bit-equal twice, out equal to the serving "
        f"forward's; {fwd_ms:.4f} ms (plain {fwd_plain:.4f}, bound {fwd_bound[0]:.4f} "
        f"{fwd_bound[1]}), SDPA forward on inputs that need grad {sdpa_fwd_ms:.4f} ms [{card}]")
    log(f"B4/B5 {name} {dt} [B {b}, T {t}, heads {hq}/{hkv}, Dh {dh}, "
        f"{'causal' if causal else 'segments'}, {pairs} allowed pairs a head]: "
        + ", ".join(f"{key} max_abs_err {r['max_abs_err']:.3g} (max |want| "
                    f"{r['max_want']:.3g}, {r['of_limit']:.3g} of the limit)"
                    for key, r in res.items())
        + f"; bit-equal twice and through the Function; B4 {b4_ms:.4f} ms (plain "
        f"{b4_plain:.4f}, bound {b4_bound[0]:.4f} {b4_bound[1]}), B5 {b5_ms:.4f} ms (plain "
        f"{b5_plain:.4f}, bound {b5_bound[0]:.4f} {b5_bound[1]}), SDPA backward "
        f"{library_ms:.4f} ms [{card}]")
    shape = {"shape": [b, t, hq, hkv, dh], "causal": causal, "pairs_per_head": pairs,
             "library_ms": library_ms}
    return ({"max_abs_err": out_err, "of_limit": out_of_limit, "lse_max_abs_err": lse_err,
             "ms": fwd_ms, "plain_ms": fwd_plain, "bound_ms": fwd_bound[0],
             "bound_by": fwd_bound[1], **shape, "library_ms": sdpa_fwd_ms},
            {"max_abs_err": max(res["dk"]["max_abs_err"], res["dv"]["max_abs_err"]),
             "of_limit": max(res["dk"]["of_limit"], res["dv"]["of_limit"]), "ms": b4_ms,
             "plain_ms": b4_plain, "bound_ms": b4_bound[0], "bound_by": b4_bound[1], **shape},
            {"max_abs_err": res["dq"]["max_abs_err"], "of_limit": res["dq"]["of_limit"],
             "ms": b5_ms, "plain_ms": b5_plain, "bound_ms": b5_bound[0],
             "bound_by": b5_bound[1], **shape})


def bwd_shapes(dev, card, shapes):
    """``bwd_shape`` at each (b, t, hq, hkv, dh, seg, causal, iters) of
    ``shapes`` in bf16 and f32. Returns the entries of the lse forward, B4
    and B5, each keyed "<name> bf16" and "<name> f32"."""
    import torch

    fwd, b4, b5 = {}, {}, {}
    for name, (b, t, hq, hkv, dh, seg, causal, iters) in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            key = f"{name} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
            fwd[key], b4[key], b5[key] = bwd_shape(dev, card, name, dtype, b, t, hq, hkv, dh,
                                                   seg, causal, iters)
            torch.cuda.empty_cache()
    return fwd, b4, b5


def remat_equality(dev, card, cut, batch, what: str) -> None:
    """At ``cut``, a depth that fits without remat, ``remat=False`` gives the
    same loss and gradients as ``remat=True`` from seed-0 weights on the card
    (15b, 16b); logs both peaks."""
    import dataclasses

    import torch

    from visual_rag_tpu_torch.models.train import Trainer

    res = {}
    for remat in (False, True):
        tr = Trainer(dataclasses.replace(cut, remat=remat), lr=1e-4, warmup=0, device=dev)
        st = tr.init_state(seed=0)
        torch.cuda.reset_peak_memory_stats()
        (loss, _), grads = tr.value_and_grad(st.params, batch)
        torch.cuda.synchronize()
        res[remat] = (float(loss), grads, torch.cuda.max_memory_allocated())
        del tr, st, loss, grads
    (l0, g0, m0), (l1, g1, m1) = res[False], res[True]
    equal = l0 == l1 and all(torch.equal(g0[k], g1[k]) for k in g0)
    rel = max(float((g1[k] - g0[k]).abs().max() / g0[k].abs().max().clamp(min=1e-30))
              for k in g0)
    log(f"remat at {what} on the same batch: loss {l1:.6f} against {l0:.6f} without, largest "
        f"gradient difference {rel:.3g} of its leaf's largest, bit-equal: {equal}; peak memory "
        f"{m1 / 2 ** 30:.2f} GiB with remat, {m0 / 2 ** 30:.2f} GiB without [{card}]")
    if not (abs(l1 - l0) <= 1e-6 * abs(l0) and rel <= 1e-5):
        raise AssertionError(f"remat changes the loss or the gradients: {l1} vs {l0}, {rel}")
    del res, g0, g1
    torch.cuda.empty_cache()


def train_full_width(dev, card, cfg, batch, name: str, n_params_want: int):
    """The main path of phases 15 and 16: ``cfg`` at full width, f32 master
    weights from seed 0 drawn on the card, ``Trainer(lr=1e-4, warmup=0)``; a
    warm step in its two halves, to split the peak memory into the state, the
    forward and backward (activations, gradients) and the optimizer's
    transient; then, counts at 0, 5 steps (each loss finite, the peak below
    the card's memory; B4 and B5 launched once a step for each attention
    layer, the lse forward twice under remat, the serving forward never).
    Frees the state. Returns the launch counts."""
    import torch

    from visual_rag_tpu_torch.models.train import Trainer
    from visual_rag_tpu_torch.ops.kernels import flash_attention as fa

    held = torch.cuda.memory_allocated()
    if held > 2 ** 30:
        raise AssertionError(f"{held / 2 ** 30:.2f} GiB allocated before the {name} state")
    t0 = time.perf_counter()
    trainer = Trainer(cfg, lr=1e-4, warmup=0, device=dev)
    state = trainer.init_state(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    state_bytes = torch.cuda.memory_allocated()
    log(f"{name} training state: {n_params} parameters, f32 master weights and AdamW moments "
        f"({12 * n_params / 2 ** 30:.2f} GiB; {state_bytes / 2 ** 30:.2f} GiB allocated on the "
        f"card, {held / 2 ** 30:.3f} of it before the state), {cfg.dtype} compute, remat "
        f"{cfg.remat}, in {time.perf_counter() - t0:.2f} s")
    if n_params != n_params_want:
        raise AssertionError(f"{name} has {n_params} parameters, not {n_params_want}")
    params, opt = state.params, state.opt_state
    torch.cuda.reset_peak_memory_stats()
    (loss, _), grads = trainer.value_and_grad(params, batch)
    torch.cuda.synchronize()
    peak_fb, with_grads = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt = trainer.optimizer.update(grads, opt, params)
    torch.cuda.synchronize()
    peak_opt = torch.cuda.max_memory_allocated()
    del grads
    losses = [float(loss)]
    total = torch.cuda.get_device_properties(dev).total_memory
    memory = {"state_gib": state_bytes / 2 ** 30, "fwd_bwd_peak_gib": peak_fb / 2 ** 30,
              "grads_gib": (with_grads - state_bytes) / 2 ** 30,
              "opt_peak_gib": peak_opt / 2 ** 30,
              "opt_transient_gib": (peak_opt - with_grads) / 2 ** 30}
    log(f"memory of a {name} step (GiB): state {memory['state_gib']:.2f}; forward and backward "
        f"peak {memory['fwd_bwd_peak_gib']:.2f} (activations and gradients "
        f"{(peak_fb - state_bytes) / 2 ** 30:.2f}, gradients alone {memory['grads_gib']:.2f}); "
        f"optimizer peak {memory['opt_peak_gib']:.2f} (transient "
        f"{memory['opt_transient_gib']:.2f}); the card has {total / 2 ** 30:.2f} [{card}]")
    step_fn = trainer.make_train_step()
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq,
                fa.flash_attention)
    for fn in counters:
        fn.launches = 0

    # -- the main path: 5 train steps --
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
    counts = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.vision.layers + 2 * cfg.text.layers
    fwd_per_layer = 2 if cfg.remat else 1  # remat runs each block's forward again
    log(f"{name}: 5 train steps after a warm one; losses {losses} (the first from the warm "
        f"step, at the initial parameters; each finite); peak memory {peak / 2 ** 30:.2f} GiB of "
        f"{total / 2 ** 30:.2f}; launches {counts} (B4 and B5 each {layers} a step: "
        f"{cfg.vision.layers} vision + {cfg.text.layers} page text + {cfg.text.layers} query "
        f"text; the lse forward {fwd_per_layer} x that; the serving forward none) [{card}]")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a {name} training loss is not finite: {losses}")
    if not max(peak, peak_fb, peak_opt) < total:
        raise AssertionError(f"the peak memory {peak} is not below the card's {total}")
    for fn, n in zip(counters, (5 * fwd_per_layer * layers, 5 * layers, 5 * layers, 0)):
        if counts[fn.__name__] != n:
            raise AssertionError(f"{fn.__name__} launched {counts[fn.__name__]} times over 5 "
                                 f"steps, not {n}")
    del params, opt, state, trainer, metrics, step_fn, loss  # step_fn holds the model
    torch.cuda.empty_cache()
    return counts


def training_phase(dev, card, hmma):
    """Phase 14: ColSmol-500M training (module docstring); ``hmma`` are the
    flash instances' HMMA counts (phase 1). Returns the kernel entries of K10's
    forward that saves lse, B4 and B5."""
    import dataclasses
    import shutil

    import torch

    from visual_rag_tpu_torch.cli.train_colvlm import QUERY_WORDS, processed_batch
    from visual_rag_tpu_torch.models.colvlm import ColVLMConfig
    from visual_rag_tpu_torch.models.embedder import VisualEmbedder
    from visual_rag_tpu_torch.models.train import (
        Trainer,
        TrainState,
        ema_update,
        restore_train_state,
        save_train_state,
    )
    from visual_rag_tpu_torch.ops.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    # 14a. B4 and B5 against their plain versions at the path's shapes (not counted)
    vision_seg = (torch.arange(17408, device=dev)[None] // 1024 + 1).to(torch.int32)
    shapes = {"vision 17 tiles": (1, 17408, 12, 12, 64, vision_seg, False, 5),
              "page text 13 tiles": (4, 896, 15, 5, 64, prefix_seg(dev, [836] * 4, 896), True,
                                     10),
              "queries": (4, 30, 15, 5, 64, prefix_seg(dev, [30, 21, 12, 25], 30), True, 10)}
    fwd, b4, b5 = bwd_shapes(dev, card, shapes)
    ptxas = training_ptxas((64,))

    # 14b. full-width ColSmol-500M: f32 master weights from seed 0 drawn on the card,
    # bf16 compute; one batch of 4 (query, page) pairs of 17-tile pages
    t0 = time.perf_counter()
    cfg = ColVLMConfig.colsmol_500m()
    trainer = Trainer(cfg, lr=1e-4, warmup=0, device=dev)
    state = trainer.init_state(seed=0)
    n_params = sum(p.numel() for p in state.params.values())
    torch.cuda.synchronize()
    log(f"ColSmol-500M training state: {n_params} parameters, f32 master weights and AdamW "
        f"moments, {cfg.dtype} compute, on the card in {time.perf_counter() - t0:.2f} s")
    if n_params != 460296512:
        raise AssertionError(f"ColSmol-500M has {n_params} parameters, not 460296512")
    processor = VisualEmbedder("vidore/colSmol-500M", config=cfg, device=dev).processor
    rng = np.random.default_rng(14)
    texts = [" ".join(rng.choice(QUERY_WORDS, int(rng.integers(4, 26)))) for _ in range(4)]
    batch = processed_batch(processor, synthetic_pages(4, 17, seed=140), texts)
    log(f"training batch: 4 pairs, patches {batch['patches'].shape}, page ids "
        f"{batch['page_ids'].shape}, queries {batch['query_ids'].shape}, window ids "
        f"{'yes' if 'window_ids' in batch else 'no'}")
    # 14c, first part: remat=True gives the same loss and gradients (not counted; at the
    # initial parameters, where the loss is far from 0)
    (l0, _), g0 = trainer.value_and_grad(state.params, batch)
    remat = Trainer(dataclasses.replace(cfg, remat=True), lr=1e-4, warmup=0, device=dev)
    (l1, _), g1 = remat.value_and_grad(state.params, batch)
    rel = max(float((g1[k] - g0[k]).abs().max() / g0[k].abs().max().clamp(min=1e-30))
              for k in g0)
    log(f"remat=True on the same batch: loss {float(l1):.6f} against {float(l0):.6f}, largest "
        f"gradient difference {rel:.3g} of its leaf's largest")
    if not (abs(float(l1) - float(l0)) <= 1e-6 * abs(float(l0)) and rel <= 1e-5):
        raise AssertionError(f"remat changes the loss or the gradients: {float(l1)} vs "
                             f"{float(l0)}, {rel}")
    del g0, g1, remat
    torch.cuda.empty_cache()
    step_fn = trainer.make_train_step()
    params, opt = state.params, state.opt_state
    params, opt, metrics = step_fn(params, opt, batch)  # warm step, not counted
    losses = [float(metrics["loss"])]
    before = {k: v.detach().clone() for k, v in params.items()}
    # the forward that saves lse, B4 and B5; the serving forward must not run in training
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq,
                fa.flash_attention)
    for fn in counters:
        fn.launches = 0

    # -- the main path: 5 train steps --
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
    counts = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    want = cfg.vision.layers + 2 * cfg.text.layers
    log(f"5 train steps after a warm one; losses {losses} (the first from the warm step, at "
        f"the initial parameters; each finite, the last below the first); peak memory "
        f"{peak / 2 ** 30:.2f} GiB; launches {counts} (the first three each {want} a step: "
        f"{cfg.vision.layers} vision + {cfg.text.layers} page text + {cfg.text.layers} query "
        f"text; the serving forward none) [{card}]")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the training loss did not fall or is not finite: {losses}")
    for fn, n in zip(counters, (5 * want,) * 3 + (0,)):
        if counts[fn.__name__] != n:
            raise AssertionError(f"{fn.__name__} launched {counts[fn.__name__]} times over 5 "
                                 f"steps, not {n}")

    # EMA of the parameters before the 5 steps with those after them
    ema = ema_update(before, params, 0.9)
    lerp_err = max(float((ema[k].double() - 0.9 * before[k].double()
                          - 0.1 * params[k].detach().double()).abs().max()) for k in ema)
    log(f"ema_update (decay 0.9) of the parameters before and after the 5 steps: largest "
        f"difference from the f64 lerp {lerp_err:.3g}")
    if not lerp_err <= 1e-6:
        raise AssertionError(f"ema_update is not the lerp: {lerp_err}")
    del ema, before
    # a checkpoint: one step from the restored state equals one from the live state
    ckpt = ROOT / "build" / "phase14_ckpt"
    t0 = time.perf_counter()
    path = save_train_state(TrainState(params, opt, 7), ckpt)
    t_save = time.perf_counter() - t0
    restored = restore_train_state(ckpt, template=state)
    shutil.rmtree(ckpt)
    live, m_live = trainer.train_step_once(TrainState(params, opt, 7), batch)
    again, m_again = trainer.train_step_once(restored, batch)
    same = (float(m_live["loss"]) == float(m_again["loss"])
            and all(torch.equal(live.params[k], again.params[k]) for k in live.params)
            and all(torch.equal(live.opt_state.nu[k], again.opt_state.nu[k]) for k in live.params))
    log(f"checkpoint: saved {path} in {t_save:.2f} s, restored (step {restored.step}); one step "
        f"from it equals one from the live state (loss, parameters, moments): {same}")
    if not same or again.step != 8:
        raise AssertionError("a step from the restored checkpoint differs from the live one")
    del again, restored, live, params, opt, state, trainer, step_fn  # step_fn holds the model
    torch.cuda.empty_cache()

    # 14c. the card against the CPU in f32 (not counted)
    cut = dataclasses.replace(cfg, dtype="float32",
                              vision=dataclasses.replace(cfg.vision, layers=2),
                              text=dataclasses.replace(cfg.text, layers=2))
    card_vs_cpu_step(dev, cut, processed_batch(processor, synthetic_pages(2, 5, seed=141),
                                               texts[:2]), "2 pairs of 5-tile pages")
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")

    def entry(name, source, line, kernel, shapes_):
        main = shapes_["vision 17 tiles bf16"]
        return {"name": name, "route": "cuda", "source": f"visual_rag_tpu_torch/csrc/{source}",
                "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line}",
                "launches": counts[name],
                "max_abs_err": max(v["max_abs_err"] for k, v in shapes_.items() if "bf16" in k),
                "max_abs_err_f32": max(v["max_abs_err"] for k, v in shapes_.items()
                                       if "f32" in k),
                "of_limit": max(v["of_limit"] for v in shapes_.values()),
                **{key: main[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                              "bound_by")},
                "shapes": shapes_,
                "ptxas": {k: v for k, v in ptxas.items() if kernel in k},
                "hmma": {k: v for k, v in hmma.items() if kernel in k}}

    return [entry("flash_attention_fwd", "flash_attention.cu", 758, "flash_fwd_lse", fwd),
            entry("flash_attention_bwd_dkv", "flash_attention_bwd.cu", 1121, "flash_bwd_dkv", b4),
            entry("flash_attention_bwd_dq", "flash_attention_bwd.cu", 1456, "flash_bwd_dq", b5)]


def merge_training_entries(training, paths):
    """Phase 14's entries of the lse forward, B4 and B5 with the shapes,
    ptxas lines and launches of the later training paths added (``paths``:
    {path name: what its phase returned}): ``launches`` over every path,
    split in ``launches_by_path``; the head dims and the largest errors over
    every shape."""
    kernel_of = {"flash_attention_fwd": ("fwd", "flash_fwd_lse"),
                 "flash_attention_bwd_dkv": ("b4", "flash_bwd_dkv"),
                 "flash_attention_bwd_dq": ("b5", "flash_bwd_dq")}
    for entry in training:
        key, kernel = kernel_of[entry["name"]]
        entry["launches_by_path"] = {"colsmol": entry["launches"]}
        for path, res in paths.items():
            entry["shapes"].update(res[key])
            entry["ptxas"].update({k: v for k, v in res["ptxas"].items() if kernel in k})
            entry["launches_by_path"][path] = res["launches"][entry["name"]]
        entry["launches"] = sum(entry["launches_by_path"].values())
        entry["head_dims"] = sorted({v["shape"][4] for v in entry["shapes"].values()})
        for field, dt in (("max_abs_err", "bf16"), ("max_abs_err_f32", "f32")):
            entry[field] = max(v["max_abs_err"] for k, v in entry["shapes"].items() if dt in k)
        entry["of_limit"] = max(v["of_limit"] for v in entry["shapes"].values())
    return training


def colpali_training_phase(dev, card):
    """Phase 15: ColPali-v1.3 training (module docstring). Returns the shapes,
    launches and ptxas lines of K10's forward that saves lse, B4 and B5 on
    this path."""
    import dataclasses
    import shutil

    from visual_rag_tpu_torch.cli.train_colvlm import QUERY_WORDS, processed_batch
    from visual_rag_tpu_torch.models.colvlm import ColVLMConfig
    from visual_rag_tpu_torch.models.embedder import VisualEmbedder

    t_phase = time.perf_counter()
    # 15a. the lse forward, B4 and B5 at the path's shapes, Dh 72 and 256 (not counted)
    shapes = {"colpali vision 1 page": (1, 1024, 16, 16, 72, prefix_seg(dev, [1024], 1024),
                                        False, 10),
              "colpali vision 4 pages": (4, 1024, 16, 16, 72,
                                         prefix_seg(dev, [1024] * 4, 1024), False, 5),
              "colpali page text 4 pages": (4, 1088, 8, 1, 256,
                                            prefix_seg(dev, [1028] * 4, 1088), False, 5),
              "colpali queries 4": (4, 32, 8, 1, 256, prefix_seg(dev, [32, 21, 12, 25], 32),
                                    False, 10)}
    fwd, b4, b5 = bwd_shapes(dev, card, shapes)
    ptxas = training_ptxas((72, 256))

    cfg = dataclasses.replace(ColVLMConfig.colpali_v13(), remat=True)
    processor = VisualEmbedder("vidore/colpali-v1.3", config=cfg, device=dev).processor
    rng = np.random.default_rng(15)
    texts = [" ".join(rng.choice(QUERY_WORDS, int(rng.integers(4, 26)))) for _ in range(4)]
    pages = [rng.random((448, 448, 3), dtype=np.float32) for _ in range(4)]
    batch = processed_batch(processor, pages, texts)
    log(f"ColPali training batch: 4 pairs, patches {batch['patches'].shape}, page ids "
        f"{batch['page_ids'].shape} ({batch['page_mask'].sum(1).tolist()} valid), queries "
        f"{batch['query_ids'].shape}")

    # 15b, first part: at a depth cut to 9 vision + 6 text layers, which fits without remat,
    # remat=False gives the same loss and gradients as remat=True (not counted)
    cut = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=9),
                              text=dataclasses.replace(cfg.text, layers=6))
    remat_equality(dev, card, cut, batch, "9 + 6 layers")

    # 15b. full-width ColPali-v1.3: f32 master weights from seed 0 drawn on the card, bf16
    # compute, remat
    counts = train_full_width(dev, card, cfg, batch, "ColPali-v1.3", COLPALI_PARAMS)

    # 15c. the card against the CPU in f32 (not counted)
    small = dataclasses.replace(cfg, dtype="float32", remat=False,
                                vision=dataclasses.replace(cfg.vision, layers=2),
                                text=dataclasses.replace(cfg.text, layers=2))
    card_vs_cpu_step(dev, small, processed_batch(processor, pages[:2], texts[:2]),
                     "2 pairs of 448 x 448 pages")

    # the CLI at full width without remat (it has no remat flag, as the JAX script has
    # none), at the largest batch of CLI_BATCHES that fits on the card; it saves the final
    # state under build/ (deleted after)
    ckpt = ROOT / "build" / "phase15_cli"
    for cli_batch in CLI_BATCHES:
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "visual_rag_tpu_torch.cli.train_colvlm", "--model",
             "vidore/colpali-v1.3", "--synthetic", "--device", "cuda", "--batch-size",
             str(cli_batch), "--steps", "3", "--log-every", "1", "--checkpoint-dir", str(ckpt)],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        t_cli = time.perf_counter() - t0
        shutil.rmtree(ckpt, ignore_errors=True)
        for line in cli.stdout.splitlines():
            log(f"  cli: {line}")
        if cli.returncode == 0:
            break
        if "OutOfMemoryError" not in cli.stderr or cli_batch == CLI_BATCHES[-1]:
            raise AssertionError(f"the ColPali CLI failed ({cli.returncode}): "
                                 f"{cli.stderr[-2000:]}")
        log(f"the CLI at {cli_batch} pairs ran out of memory without remat, after "
            f"{t_cli:.1f} s: " + cli.stderr.strip().splitlines()[-1][:300])
    log(f"the CLI (--model vidore/colpali-v1.3 --synthetic --batch-size {cli_batch}, 3 steps, "
        f"no remat) took {t_cli:.1f} s with its process start and checkpoint [{card}]")
    log(f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return {"fwd": fwd, "b4": b4, "b5": b5, "ptxas": ptxas, "launches": counts}


COLQWEN_PARAMS = 3963137408  # ColQwen2.5-v0.2 (Qwen2.5-VL-3B), as the flax init counts them
A4_PAGE = (1170, 827)  # px (height, width): 74 x 54 patches for ColQwen, phase 13's first page


def colqwen_training_phase(dev, card):
    """Phase 16: ColQwen2.5-v0.2 training (module docstring). Returns the
    shapes, launches and ptxas lines of K10's forward that saves lse, B4 and
    B5 on this path."""
    import dataclasses

    import torch

    from visual_rag_tpu_torch.cli.train_colvlm import QUERY_WORDS, processed_batch
    from visual_rag_tpu_torch.models.attention import segment_ids
    from visual_rag_tpu_torch.models.colvlm import ColVLMConfig
    from visual_rag_tpu_torch.models.embedder import VisualEmbedder

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(ColVLMConfig.colqwen25_v02(), remat=True)
    processor = VisualEmbedder("vidore/colqwen2.5-v0.2", config=cfg, device=dev).processor
    rng = np.random.default_rng(16)
    texts = [" ".join(rng.choice(QUERY_WORDS, int(rng.integers(4, 26)))) for _ in range(4)]
    pages = [rng.random(A4_PAGE + (3,), dtype=np.float32) for _ in range(4)]
    batch = processed_batch(processor, pages, texts)
    log(f"ColQwen training batch: 4 pairs of A4 pages, patches {batch['patches'].shape} "
        f"({batch['patch_mask'].sum(1).tolist()} valid), window ids "
        f"{'yes' if 'window_ids' in batch else 'no'}, page ids {batch['page_ids'].shape} "
        f"({batch['page_mask'].sum(1).tolist()} valid), queries {batch['query_ids'].shape}")

    # 16a. the lse forward, B4 and B5 at the path's shapes, Dh 80 and 128 (not counted)
    valid = torch.from_numpy(batch["patch_mask"]).to(dev)
    window = segment_ids(valid, torch.from_numpy(batch["window_ids"]).to(dev))
    n_patches, t_text, t_q = (batch[k].shape[1] for k in ("patch_mask", "page_ids", "query_ids"))
    heads, dv = cfg.vision.heads, cfg.vision.hidden // cfg.vision.heads
    th, tkv, dt = cfg.text.heads, cfg.text.kv_heads, cfg.text.hidden // cfg.text.heads
    shapes = {
        "colqwen vision window 1 page": (1, n_patches, heads, heads, dv, window[:1], False, 10),
        "colqwen vision window 4 pages": (4, n_patches, heads, heads, dv, window, False, 5),
        "colqwen vision full 1 page": (1, n_patches, heads, heads, dv,
                                       valid[:1].to(torch.int32), False, 5),
        "colqwen page text 4 pages": (4, t_text, th, tkv, dt,
                                      prefix_seg(dev, batch["page_mask"].sum(1).tolist(), t_text),
                                      True, 5),
        "colqwen queries 4": (4, t_q, th, tkv, dt,
                              prefix_seg(dev, batch["query_mask"].sum(1).tolist(), t_q), True,
                              10)}
    fwd, b4, b5 = bwd_shapes(dev, card, shapes)
    live = live_tile_pairs(window[0])
    log(f"ColQwen window layer, one A4 page: the lse forward, B4 and B5 compute {live} of "
        f"{(n_patches // 64) ** 2} (query tile, kv tile) pairs a head, {live * 64 * 64} key "
        f"pairs against {allowed_pair_count(window[:1], False)} allowed")
    for kernel in (fwd, b4, b5):
        kernel["colqwen vision window 1 page bf16"]["live_tile_pairs"] = live
    ptxas = training_ptxas((80, 128))
    del window, valid, shapes

    # 16b. at a depth cut to 8 vision layers (the eighth full attention) + 4 text layers,
    # which fits without remat, remat=False gives the same loss and gradients as remat=True
    # (not counted)
    cut = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=8,
                                                              full_attn_layers=(7,)),
                              text=dataclasses.replace(cfg.text, layers=4))
    remat_equality(dev, card, cut, batch, "8 (7 window, 1 full) + 4 layers")

    # 16c. full-width ColQwen2.5-v0.2: f32 master weights from seed 0 drawn on the card, bf16
    # compute, remat
    counts = train_full_width(dev, card, cfg, batch, "ColQwen2.5-v0.2", COLQWEN_PARAMS)

    # 16d. the card against the CPU in f32 at full width, the depth cut to 2 vision layers
    # (the second full attention) + 2 text layers, 2 pairs of 448 x 448 pages (1024 patches:
    # the processor of a config whose tower takes 1024) (not counted)
    small = dataclasses.replace(cfg, dtype="float32", remat=False,
                                vision=dataclasses.replace(cfg.vision, layers=2,
                                                           full_attn_layers=(1,),
                                                           max_patches=1024),
                                text=dataclasses.replace(cfg.text, layers=2))
    small_proc = VisualEmbedder("vidore/colqwen2.5-v0.2", config=small, device=dev).processor
    small_pages = [rng.random((448, 448, 3), dtype=np.float32) for _ in range(2)]
    small_batch = processed_batch(small_proc, small_pages, texts[:2])
    if small_batch["patch_mask"].sum(1).tolist() != [1024, 1024]:
        raise AssertionError(f"the small pages have {small_batch['patch_mask'].sum(1)} patches")
    card_vs_cpu_step(dev, small, small_batch, "2 pairs of 448 x 448 pages (1024 patches)")
    log(f"phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return {"fwd": fwd, "b4": b4, "b5": b5, "ptxas": ptxas, "launches": counts}


# K11 against its plain version: h, y and the output are each rounded to bf16 from f32 sums
# taken in another order, so the output stays within two bf16 roundings of its largest value
MOE_TOL = 2.0 ** -7
KIMI_MOE = dict(hidden=2048, width=1408, experts=64, top_k=6)
KIMI_BATCH_ROWS = 8 * 1088  # the ingest cell's batch: 8 pages of 1088 text rows (padded)


def moe_experts_phase(dev, card):
    """Phase 17: K11 (``csrc/moe_experts.cu``) at Kimi-VL-A3B's widths on one
    routed layer of the ingest cell's batch (8 x 1088 rows, 6 experts each of
    64; ``tools/emulate_kernels.py::moe_inputs``): a uniform and a skewed
    layout (expert 0 in every row, experts 60-63 empty) against its plain
    version (the same layout through f32 matmuls on the card) within
    ``MOE_TOL`` of the largest output, two calls bit-equal,
    launches counted; then its time on the uniform layout beside the plain
    version's and its bound (the routed experts' 2 x 3 x 2048 x 1408 flops a
    pair at the bf16 peak, against every expert's bf16 weights, x, the
    shared output and the output once, and the f32 weights)."""
    import torch

    from visual_rag_tpu_torch.ops.kernels import moe_experts as me
    from visual_rag_tpu_torch.tools.emulate_kernels import moe_inputs

    t_phase = time.perf_counter()
    t = KIMI_BATCH_ROWS
    h, w, e, k = (KIMI_MOE[n] for n in ("hidden", "width", "experts", "top_k"))
    entry = {"name": "moe_experts", "route": "cuda", "shape": [t, k, e, h, w], "max_abs_err": 0.0}
    for spread, seed in (("skewed", 17), ("uniform", 18)):
        args = moe_inputs(t, k, e, h, w, spread, seed=seed, device=dev)
        before = me.moe_experts.launches
        got, again = me.moe_experts(*args), me.moe_experts(*args)
        want = me.moe_experts_plain(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        top = float(want.float().abs().max())
        empty = int((args[4].counts == 0).sum())
        log(f"moe_experts {spread} [{t} rows x {k} of {e} experts, {empty} empty]: max_abs_err "
            f"{err:.3g} of {top:.3g} (limit {MOE_TOL * top:.3g}) [{card}]")
        if err > MOE_TOL * top or not torch.equal(got, again):
            raise AssertionError(f"moe_experts {spread}: error {err} or two calls differ")
        if me.moe_experts.launches != before + 2:
            raise AssertionError("moe_experts did not count its launches")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    ms = cuda_ms(lambda: me.moe_experts(*args), iters=20)
    plain_ms = cuda_ms(lambda: me.moe_experts_plain(*args), iters=3)
    flops = 2.0 * t * k * 3 * h * w
    nbytes = e * 3 * h * w * 2 + 3 * t * h * 2 + t * k * 4
    bound_ms, by = bound(nbytes, flops, "bf16")
    log(f"moe_experts uniform [{t} x {k} of {e}]: kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"bound {bound_ms:.4f} ms ({by}), {100 * bound_ms / ms:.1f}% of it [{card}]")
    entry.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=by,
                 launches=me.moe_experts.launches)
    log(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return entry


if __name__ == "__main__":
    main()
