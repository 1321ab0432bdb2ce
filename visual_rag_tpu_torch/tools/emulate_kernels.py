"""Run the tensor-core kernels' CUDA sources on the CPU, against their plain versions.

    python visual_rag_tpu_torch/tools/emulate_kernels.py [--asan] [DH,T,HQ,HKV,CAUSAL,TILE ...]
    python visual_rag_tpu_torch/tools/emulate_kernels.py --stage1 [--asan] [B,D,P,DTYPE,SCALED,SMS ...]
    python visual_rag_tpu_torch/tools/emulate_kernels.py --dedup [--asan] [B,K,D,NQ,DTYPE,...]
    python visual_rag_tpu_torch/tools/emulate_kernels.py --moe [--asan] [T,TOPK,E,HIDDEN,...]

compiles ``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``,
``csrc/pooled_stage1.cu``, ``csrc/maxsim_dedup_mma.cu`` and ``csrc/moe_experts.cu``
with g++ against
``tools/cuda_emu.h`` (a CPU model
of the CUDA launch: threads, barriers, shuffles, NaN-filled shared memory of
the launch's exact size, the SM count the grid is sized by, and the
tensor-core building blocks of ``csrc/mma_tiles.cuh``: ``mma.sync`` m16n8k16
in bf16 and f16 with the PTX fragment layout, ``ldmatrix`` plain and
``.trans``, ``cp.async`` with zero-fill) into ``build/kernels/emu/``, points
the wrappers of ``ops/kernels/flash_attention.py``,
``ops/kernels/prefetch_topk.py`` and ``ops/kernels/maxsim_rerank.py`` at that
library for CPU tensors, and holds
K10 (serving and with lse), B4 and B5 against their plain versions in f32
and bf16, at the limits of ``chip_smoke.py`` (``K10_TOL``, ``BWD_TOL``,
``LSE_ATOL``). Each case is ``DH,T,HQ,HKV,CAUSAL,TILE`` (TILE: rows a
segment, or None for two segments; then pads), as in
``tests/test_torch_port_cuda.py``; the default cases cover every instance.
In bf16 the grouped cases split B4's head groups over more blocks, as
``csrc/flash_attention_bwd.cu`` does on the H100's 132 SMs (the last two at
the 8-head groups of ColPali's and ColQwen2.5's text).
``--stage1`` holds the pooled stage-1 instead (``check_stage1``, the cases of
``STAGE1_CASES``: queries, docs, pooled rows, store dtype, scales, SMs), and
``--dedup`` K3's tensor-core body (``check_dedup``, the cases of
``DEDUP_CASES``: queries, candidates each, docs, query rows, store dtype,
per-doc scales, SMs, how the candidates spread), and ``--moe`` K11, the
routed experts (``check_moe``, the cases of ``MOE_CASES``: tokens, experts a
token, experts, hidden, expert width, how the tokens spread).
``--asan`` builds with AddressSanitizer, which must be preloaded:
``LD_PRELOAD=$(gcc -print-file-name=libasan.so) ASAN_OPTIONS=detect_leaks=0``.

It checks indexing, tile skips and numerics before a kernel's first call on
the card; it says nothing of registers, spills, speed or whether nvcc takes
the source. Small shapes only: a block's 256 threads are fibers that one OS
thread runs in turn, and every ``mma``, ``ldmatrix`` and barrier is a pass
of context switches over the block. Each line also says how many slices bf16
B4 split each head group into.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCES = ("flash_common.cuh", "flash_mma.cuh", "flash_attention.cu", "flash_attention_bwd.cu",
           "pooled_stage1.cu", "maxsim_dedup_mma.cu", "moe_experts.cu")
CASES = ((64, 130, 3, 1, True, None), (72, 150, 4, 4, False, None), (72, 200, 2, 2, True, 64),
         (80, 100, 2, 2, False, None), (80, 200, 2, 2, False, 64), (128, 90, 4, 2, True, None),
         (256, 100, 8, 1, False, None), (256, 150, 2, 1, True, 40),
         (256, 150, 8, 1, False, None), (128, 300, 16, 2, True, None))
# the pooled stage-1: (queries, docs, pooled rows, store dtype, scaled, SMs); docs that
# are not a multiple of the 32-doc tile, odd and even; two query tiles; blocks that walk
# several doc tiles (few SMs); P = 1; int8 codes with and without scales
STAGE1_CASES = ((3, 13, 1, "bf16", False, 132), (70, 100, 10, "f16", False, 132),
                (300, 45, 4, "int8", True, 132), (5, 200, 3, "bf16", False, 4),
                (9, 64, 5, "int8", False, 2))
# K3's tensor-core body: (queries, candidates each, docs, query rows, store dtype, per-doc
# scales, SMs, spread). Docs of 0, 1, 128, 129 and up to 299 rows (not multiples of the
# 128-row slab); query rows 3 (runs of up to 16 pairs), 16 (16 pairs, one tile each), 24,
# 32 and 33 (runs of 12 and 8), 130 (runs of 2 pairs of 9 tiles); "heavy" puts the
# candidates on 4 docs (runs cut at the most a run holds), "uniform" on every doc (runs
# of one pair); blocks that walk many runs (2 to 4 SMs) and one run a block (132)
DEDUP_CASES = ((6, 7, 40, 3, "bf16", False, 132, "uniform"),
               (20, 9, 6, 32, "bf16", False, 2, "heavy"),
               (5, 6, 11, 33, "f16", True, 3, "uniform"),
               (24, 4, 5, 16, "f16", False, 4, "heavy"),
               (4, 5, 7, 130, "int8", True, 2, "uniform"),
               (12, 8, 13, 24, "int8", False, 132, "heavy"))
# K11: (tokens, experts a token, experts, hidden, expert width, spread). "skewed" sends
# most pairs to expert 0 (many tiles, a part-full last one) and leaves some experts
# empty; "uniform" spreads them; one token; widths of one and of several column blocks
MOE_CASES = ((37, 2, 5, 128, 64, "skewed"), (70, 3, 4, 256, 128, "uniform"),
             (1, 2, 6, 128, 64, "uniform"))


def emulated_source(text: str) -> str:
    """A CUDA source as ``cuda_emu.h`` runs it: each ``k<<<grid, block, smem,
    stream>>>(args)`` becomes ``emu_launch(dim3(grid), block, smem, k, args)``
    and the dynamic shared memory a pointer to the launch's buffer."""
    text = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>\(",
                  r"emu_launch(dim3(\2), \3, \4, \1, ", text)
    return text.replace("extern __shared__ __align__(16) float smem[];",
                        "float* smem = emu_smem;")


def write_sources(dst: Path) -> None:
    """The sources as g++ builds them into ``dst``: their launches rewritten, and
    the CUDA headers and the tensor-core building blocks (``mma_tiles.cuh``) as
    ``cuda_emu.h``'s models; compile with ``-I dst -I tools``."""
    dst.mkdir(parents=True, exist_ok=True)
    for name in SOURCES:
        text = (ROOT / "visual_rag_tpu_torch" / "csrc" / name).read_text()
        (dst / name).write_text(emulated_source(text))
    for header in ("cuda_runtime.h", "cuda_bf16.h", "cuda_fp16.h", "math_constants.h",
                   "mma_tiles.cuh"):
        (dst / header).write_text('#pragma once\n#include "cuda_emu.h"\n')


def build(asan: bool, out: Path = ROOT / "build" / "kernels" / "emu") -> Path:
    """The emulated library, built in ``out``."""
    write_sources(out / "src")
    (out / "src" / "errors.cpp").write_text(
        '#include "cuda_emu.h"\n'
        'extern "C" const char* vrt_error_string(int) { return "emulated launch refused"; }\n'
        'extern "C" void vrt_emu_set_sms(int n) { emu_sms = n; }\n')
    lib = out / ("libemu_asan.so" if asan else "libemu.so")
    flags = ["-fsanitize=address", "-fno-omit-frame-pointer"] if asan else []
    cmd = ["g++", "-std=c++20", "-O2", "-g", "-fPIC", "-shared",
           "-fno-strict-aliasing", *flags, "-I", str(out / "src"),
           "-I", str(Path(__file__).resolve().parent), "-o", str(lib), "-x", "c++",
           str(out / "src" / "flash_attention.cu"), str(out / "src" / "flash_attention_bwd.cu"),
           str(out / "src" / "pooled_stage1.cu"), str(out / "src" / "maxsim_dedup_mma.cu"),
           str(out / "src" / "moe_experts.cu"), str(out / "src" / "errors.cpp")]
    subprocess.run(cmd, check=True)
    return lib


def use_library(lib_path: Path):
    """Point the wrappers' kernel path at the emulated library for CPU tensors:
    the flash-attention wrappers', the pooled stage-1's (``prefetch_topk``),
    K3's (``maxsim_rerank``; its tensor-core body, the only one built) and
    K11's (``moe_experts``)."""
    from visual_rag_tpu_torch.ops.kernels import _build
    from visual_rag_tpu_torch.ops.kernels import flash_attention as fa
    from visual_rag_tpu_torch.ops.kernels import maxsim_rerank as mr
    from visual_rag_tpu_torch.ops.kernels import moe_experts as me
    from visual_rag_tpu_torch.ops.kernels import prefetch_topk as pt

    lib = ctypes.CDLL(str(lib_path))
    _build._declare_flash(lib)
    _build._declare_stage1(lib)
    _build._declare_dedup_mma(lib)
    _build._declare_moe(lib)
    for fn in (lib.vrt_flash_attention, lib.vrt_flash_attention_bwd_dkv,
               lib.vrt_flash_attention_bwd_dq, lib.vrt_flash_attention_bwd_dkv_scratch,
               lib.vrt_pooled_stage1_scores, lib.vrt_rerank_candidates_dedup_mma,
               lib.vrt_moe_experts):
        fn.argtypes = [ctypes.c_void_p, *fn.argtypes[1:]]  # a CPU tensor's device index: None
    lib.vrt_error_string.argtypes = [ctypes.c_int]
    lib.vrt_error_string.restype = ctypes.c_char_p
    lib.vrt_emu_set_sms.argtypes = [ctypes.c_int]
    _build.load_library = lambda: lib
    for mod in (fa, pt, mr, me):
        mod.on_cpu = lambda t: False
        mod.stream_ptr = lambda device: ctypes.c_void_p(None)
    return fa


def b4_slices(dtype, b, t, hq, hkv, dh) -> int:
    """The slices B4 splits each head group into at these arguments: its scratch
    beyond the range table holds two f32 partial sums of dk's size a slice."""
    import torch

    from visual_rag_tpu_torch.ops.kernels import _build

    code = 0 if dtype == torch.float32 else 1
    scratch = _build.load_library().vrt_flash_attention_bwd_dkv_scratch(
        None, code, b, t, hq, hkv, dh)
    ranges = (8 * b * -(-t // 32) + 255) // 256 * 256
    return max(1, (scratch - ranges) // (2 * 4 * b * t * hkv * dh))


def check(fa, dh, t, hq, hkv, causal, tile) -> bool:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import BWD_TOL, K10_TOL, LSE_ATOL

    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        rng = np.random.default_rng(t + dh)
        qkv = torch.from_numpy(rng.standard_normal((2, t, hq + 2 * hkv, dh)).astype(np.float32))
        qkv = qkv.to(dtype)  # q, k, v as strided views of one tensor
        q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
        seg = np.zeros((2, t), np.int32)
        for i in range(2):
            n = t - int(rng.integers(0, t // 3))
            seg[i, :n] = (np.arange(n) // tile + 1) if tile else 1 + (np.arange(n) >= n // 2)
        seg = torch.from_numpy(seg)
        do = torch.from_numpy(rng.standard_normal((2, t, hq, dh)).astype(np.float32)).to(dtype)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fa.flash_attention(q, k, v, seg, causal=causal)
        want, lse_p = fa.flash_attention_fwd_plain(q, k, v, seg, causal=causal)
        rtol, atol = K10_TOL[dt]
        errs = {"out": float(((out.float() - want.float()).abs()
                              / (atol + rtol * want.float().abs())).max())}
        out2, lse = fa.flash_attention_fwd(q, k, v, seg, causal=causal)
        errs["lse forward vs serving"] = 0.0 if torch.equal(out, out2) else float("inf")
        fin = torch.isfinite(lse_p)
        same_inf = torch.equal(torch.isinf(lse), torch.isinf(lse_p))
        errs["lse"] = (float((lse - lse_p)[fin].abs().max()) / LSE_ATOL if same_inf
                       else float("inf"))
        di = fa.attention_di(out, do)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, do, lse, di, causal=causal)
        dq = fa.flash_attention_bwd_dq(q, k, v, seg, do, lse, di, causal=causal)
        wdk, wdv = fa.flash_attention_bwd_dkv_plain(q, k, v, seg, do, lse, di, causal=causal)
        wdq = fa.flash_attention_bwd_dq_plain(q, k, v, seg, do, lse, di, causal=causal)
        rtol, atol = BWD_TOL[dt]
        for name, got, w in (("dq", dq, wdq), ("dk", dk, wdk), ("dv", dv, wdv)):
            w = w.float()
            errs[name] = float(((got.float() - w).abs()
                                / (atol * w.abs().max() + rtol * w.abs())).max())
        good = all(e <= 1.0 for e in errs.values())  # NaN compares False: a fault
        ok &= good
        print(f"Dh {dh} T {t} heads {hq}/{hkv} {'causal' if causal else 'segments'} tile {tile}"
              f" {dt}: " + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
              + f" of the limit; B4 in {b4_slices(dtype, 2, t, hq, hkv, dh)} slices"
              f" ({time.perf_counter() - t0:.1f} s) {'ok' if good else 'FAIL'}", flush=True)
    return ok


STAGE1_DTYPES = {"bf16": "bfloat16", "f16": "float16", "int8": "int8"}


def check_stage1(b, d, p, dtype, scaled, sms) -> bool:
    """The pooled stage-1 kernel through its wrapper against its plain
    version: within 1e-5 (the emulated ``mma`` sums exactly; only the plain
    version's f32 order differs), docs with no valid row exactly 0, two
    calls bit-equal, one launch counted a call."""
    import numpy as np
    import torch

    from visual_rag_tpu_torch.index.quantize import quantize_rows_int8
    from visual_rag_tpu_torch.ops.kernels import _build
    from visual_rag_tpu_torch.ops.kernels import prefetch_topk as pt

    _build.load_library().vrt_emu_set_sms(sms)
    rng = np.random.default_rng(b * 1000 + d + p)
    vals = torch.from_numpy(rng.standard_normal((p, d, 128)).astype(np.float32))
    vals = torch.nn.functional.normalize(vals, dim=-1)
    mask = torch.from_numpy(rng.random((p, d)) > 0.3)
    mask[:, [0, d - 1]] = False  # docs with no valid row, the last one included
    pooled = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((b, 128)).astype(np.float32)), dim=-1)
    pooled[0] = -pooled[0]  # a query whose dots are mostly of the other sign
    scales = None
    if dtype == "int8":
        vals, row_scales = quantize_rows_int8(vals)
        scales = row_scales if scaled else None
    else:
        vals = vals.to(getattr(torch, STAGE1_DTYPES[dtype]))
    t0 = time.perf_counter()
    before = pt.pooled_stage1_scores.launches
    got, again = (pt.pooled_stage1_scores(vals, mask, pooled, scales) for _ in range(2))
    want = pt.pooled_stage1_scores_ref(vals, mask, pooled, scales)
    err = float((got - want).abs().max())
    empty = ~mask.any(dim=0)
    good = (err <= 1e-5 and torch.equal(got, again) and bool((got[:, empty] == 0).all())
            and pt.pooled_stage1_scores.launches == before + 2)
    print(f"stage1 B {b} D {d} P {p} {dtype}{' scaled' if scales is not None else ''} "
          f"{sms} SMs: max abs err {err:.3g} ({time.perf_counter() - t0:.1f} s) "
          f"{'ok' if good else 'FAIL'}", flush=True)
    return good


def stage1_case(text: str):
    """``B,D,P,DTYPE,SCALED,SMS`` as a case of ``STAGE1_CASES``."""
    b, d, p, dtype, scaled, sms = text.split(",")
    return int(b), int(d), int(p), dtype, scaled == "True", int(sms)


DEDUP_DTYPES = {"bf16": "bfloat16", "f16": "float16", "int8": "int8"}


def dedup_inputs(b, k, d, nq, dtype, scaled, spread):
    """The arguments of ``rerank_candidates_dedup`` for a case of ``DEDUP_CASES``
    (d >= 5): a ragged store of unit rows with docs of 0, 1, 128, 129 and 2-299
    rows at 32-row aligned offsets (int8: per-doc codes and their scales); queries
    of 1 to nq valid rows (one of nq); candidates with -1, an id past the store
    and the empty doc."""
    import numpy as np
    import torch

    from visual_rag_tpu_torch.index.quantize import quantize_per_doc

    rng = np.random.default_rng(b * 1000 + k * 100 + d + nq)
    lengths = rng.integers(2, 300, d).astype(np.int32)
    lengths[[0, 1, 2, 3]] = 0, 1, 128, 129
    aligned = (lengths + 31) // 32 * 32
    offsets = np.concatenate([[0], np.cumsum(aligned[:-1])]).astype(np.int32)
    rows = int(aligned.sum()) + 320
    flat = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((rows, 128)).astype(np.float32)), dim=-1)
    offsets, lengths = torch.from_numpy(offsets), torch.from_numpy(lengths)
    scales = (torch.from_numpy(rng.uniform(0.5, 2.0, d).astype(np.float32))
              if scaled else None)
    if dtype == "int8":
        flat, doc_scales = quantize_per_doc(flat, offsets, lengths)
        scales = doc_scales if scaled else None
    else:
        flat = flat.to(getattr(torch, DEDUP_DTYPES[dtype]))
    q = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((b, nq, 128)).astype(np.float32)), dim=-1)
    valid = rng.integers(1, nq + 1, b)
    valid[0] = nq
    qmask = (torch.arange(nq)[None, :] < torch.from_numpy(valid)[:, None]).float()
    hi = min(4, d) if spread == "heavy" else d
    cand = rng.integers(0, hi, (b, k))
    cand[::3, 0] = -1
    cand[1 % b, -1] = d + 3  # out of range: scored as -1
    cand[2 % b, k // 2] = 0  # the empty doc
    return (flat, offsets, lengths, q, qmask, torch.from_numpy(cand.astype(np.int32)),
            int(lengths.max()), scales)


def check_dedup(b, k, d, nq, dtype, scaled, spread, sms) -> bool:
    """K3's tensor-core body through ``rerank_candidates_dedup`` against its
    plain version: within ``ATOL`` of ``tests/test_torch_port_cuda.py`` (1e-3;
    the emulated ``mma`` sums exactly, so only the plain version's f32 order
    differs), NEG_INF where the plain version has it, two calls bit-equal, one
    launch of the tensor-core body counted a call."""
    import torch

    from visual_rag_tpu_torch.ops.kernels import _build
    from visual_rag_tpu_torch.ops.kernels import maxsim_rerank as mr

    _build.load_library().vrt_emu_set_sms(sms)
    args = dedup_inputs(b, k, d, nq, dtype, scaled, spread)
    t0 = time.perf_counter()
    before = (mr.rerank_candidates_dedup.launches, mr.rerank_candidates_dedup.mma_launches)
    got, again = (mr.rerank_candidates_dedup(*args) for _ in range(2))
    want = mr.rerank_candidates_dedup_ref(*args)
    err = float((got - want).abs().max())
    run_pairs = mr.dedup_run_pairs(args[0].dtype, 128, nq)
    n_runs = int((mr.dedup_layout(args[5], args[2], run_pairs)[2] < b * k).sum())
    good = (err <= 1e-3 and torch.equal(got, again)
            and torch.equal(got == mr.NEG_INF, want == mr.NEG_INF)
            and (mr.rerank_candidates_dedup.launches,
                 mr.rerank_candidates_dedup.mma_launches) == (before[0] + 2, before[1] + 2))
    print(f"dedup B {b} K {k} D {d} NQ {nq} {dtype}{' scaled' if scaled else ''} {spread} "
          f"{sms} SMs: {n_runs} runs of <= {run_pairs} pairs, max abs err {err:.3g} "
          f"({time.perf_counter() - t0:.1f} s) {'ok' if good else 'FAIL'}", flush=True)
    return good


def dedup_case(text: str):
    """``B,K,D,NQ,DTYPE,SCALED,SMS,SPREAD`` as a case of ``DEDUP_CASES``."""
    b, k, d, nq, dtype, scaled, sms, spread = text.split(",")
    return int(b), int(k), int(d), int(nq), dtype, scaled == "True", int(sms), spread


def moe_inputs(t, topk, e, hidden, inter, spread, seed=0, device="cpu"):
    """x, gate, up, down, the layout, the weights and the shared output of
    one K11 case in bf16, drawn on ``device`` (the card's tests and
    ``chip_smoke.py`` draw Kimi-VL's widths there). ``skewed``: expert 0 in
    every token's choice and the last ``max(2, e // 16)`` experts in none."""
    import torch

    from visual_rag_tpu_torch.ops.kernels.moe_experts import expert_layout

    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device).mul_(scale).bfloat16()

    x = normal(t, hidden)
    gate, up = normal(e, inter, hidden, scale=hidden ** -0.5), normal(e, inter, hidden,
                                                                        scale=hidden ** -0.5)
    down = normal(e, hidden, inter, scale=inter ** -0.5)
    scores = torch.rand(t, e, generator=gen, device=device)
    if spread == "skewed":
        scores[:, 0] = 2.0
        scores[:, e - max(2, e // 16):] = -1.0
    idx = torch.topk(scores, topk, dim=-1).indices
    w = torch.rand(t, topk, generator=gen, device=device)
    return x, gate, up, down, expert_layout(idx, e), w, normal(t, hidden)


def check_moe(t, topk, e, hidden, inter, spread) -> bool:
    """K11 through ``moe_experts`` against its plain version: within 2**-7
    of the output's largest value (two bf16 roundings: h, y and the output
    are rounded on both sides from f32 sums taken in another order), two
    calls bit-equal, one launch counted a call."""
    import torch

    from visual_rag_tpu_torch.ops.kernels import moe_experts as me

    args = moe_inputs(t, topk, e, hidden, inter, spread)
    t0 = time.perf_counter()
    before = me.moe_experts.launches
    got, again = (me.moe_experts(*args) for _ in range(2))
    want = me.moe_experts_plain(*args)
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    good = (err <= 2.0 ** -7 * top and torch.equal(got, again)
            and me.moe_experts.launches == before + 2)
    empty = int((args[4].counts == 0).sum())
    print(f"moe T {t} top {topk} E {e} hidden {hidden} width {inter} {spread} ({empty} experts "
          f"empty): max abs err {err:.3g} of {top:.3g} ({time.perf_counter() - t0:.1f} s) "
          f"{'ok' if good else 'FAIL'}", flush=True)
    return good


def moe_case(text: str):
    """``T,TOPK,E,HIDDEN,WIDTH,SPREAD`` as a case of ``MOE_CASES``."""
    t, k, e, h, n, spread = text.split(",")
    return int(t), int(k), int(e), int(h), int(n), spread


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    asan = "--asan" in argv
    stage1 = "--stage1" in argv
    dedup = "--dedup" in argv
    moe = "--moe" in argv
    args = [c for c in argv if c not in ("--asan", "--stage1", "--dedup", "--moe")]
    fa = use_library(build(asan))
    if moe:
        ok = all([check_moe(*case) for case in ([moe_case(c) for c in args] or MOE_CASES)])
    elif stage1:
        cases = [stage1_case(c) for c in args] or STAGE1_CASES
        ok = all([check_stage1(*case) for case in cases])
    elif dedup:
        cases = [dedup_case(c) for c in args] or DEDUP_CASES
        ok = all([check_dedup(b, k, d, nq, dt, sc, spread, sms)
                  for b, k, d, nq, dt, sc, sms, spread in cases])
    else:
        cases = [tuple(eval(c)) for c in args] or CASES
        ok = all([check(fa, *case) for case in cases])
    print("all cases within their limits" if ok else "SOME CASES FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
