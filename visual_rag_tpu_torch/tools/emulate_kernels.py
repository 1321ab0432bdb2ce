"""Run the flash-attention kernels' CUDA sources on the CPU, against their plain versions.

    python visual_rag_tpu_torch/tools/emulate_kernels.py [--asan] [DH,T,HQ,HKV,CAUSAL,TILE ...]

compiles ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` with
g++ against ``tools/cuda_emu.h`` (a CPU model of the CUDA launch: threads,
barriers, shuffles, NaN-filled shared memory of the launch's exact size, and
of the tensor-core building blocks of ``csrc/mma_tiles.cuh``: ``mma.sync``
m16n8k16 in bf16 with the PTX fragment layout, ``ldmatrix`` plain and
``.trans``, ``cp.async`` with zero-fill) into ``build/kernels/emu/``, points
the wrappers of
``ops/kernels/flash_attention.py`` at that library for CPU tensors, and holds
K10 (serving and with lse), B4 and B5 against their plain versions in f32
and bf16, at the limits of ``chip_smoke.py`` (``K10_TOL``, ``BWD_TOL``,
``LSE_ATOL``). Each case is ``DH,T,HQ,HKV,CAUSAL,TILE`` (TILE: rows a
segment, or None for two segments; then pads), as in
``tests/test_torch_port_cuda.py``; the default cases cover every instance.
In bf16 the grouped cases split B4's head groups over more blocks, as
``csrc/flash_attention_bwd.cu`` does on the H100's 132 SMs (the last two at
the 8-head groups of ColPali's and ColQwen2.5's text).
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
SOURCES = ("flash_common.cuh", "flash_mma.cuh", "flash_attention.cu", "flash_attention_bwd.cu")
CASES = ((64, 130, 3, 1, True, None), (72, 150, 4, 4, False, None), (72, 200, 2, 2, True, 64),
         (80, 100, 2, 2, False, None), (80, 200, 2, 2, False, 64), (128, 90, 4, 2, True, None),
         (256, 100, 8, 1, False, None), (256, 150, 2, 1, True, 40),
         (256, 150, 8, 1, False, None), (128, 300, 16, 2, True, None))


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
    for header in ("cuda_runtime.h", "cuda_bf16.h", "math_constants.h", "mma_tiles.cuh"):
        (dst / header).write_text('#pragma once\n#include "cuda_emu.h"\n')


def build(asan: bool, out: Path = ROOT / "build" / "kernels" / "emu") -> Path:
    """The emulated library, built in ``out``."""
    write_sources(out / "src")
    (out / "src" / "errors.cpp").write_text(
        'extern "C" const char* vrt_error_string(int) { return "emulated launch refused"; }\n')
    lib = out / ("libemu_asan.so" if asan else "libemu.so")
    flags = ["-fsanitize=address", "-fno-omit-frame-pointer"] if asan else []
    cmd = ["g++", "-std=c++20", "-O2", "-g", "-fPIC", "-shared",
           "-fno-strict-aliasing", *flags, "-I", str(out / "src"),
           "-I", str(Path(__file__).resolve().parent), "-o", str(lib), "-x", "c++",
           str(out / "src" / "flash_attention.cu"), str(out / "src" / "flash_attention_bwd.cu"),
           str(out / "src" / "errors.cpp")]
    subprocess.run(cmd, check=True)
    return lib


def use_library(lib_path: Path):
    """Point the wrappers' kernel path at the emulated library for CPU tensors."""
    from visual_rag_tpu_torch.ops.kernels import _build
    from visual_rag_tpu_torch.ops.kernels import flash_attention as fa

    lib = ctypes.CDLL(str(lib_path))
    _build._declare_flash(lib)
    for fn in (lib.vrt_flash_attention, lib.vrt_flash_attention_bwd_dkv,
               lib.vrt_flash_attention_bwd_dq, lib.vrt_flash_attention_bwd_dkv_scratch):
        fn.argtypes = [ctypes.c_void_p, *fn.argtypes[1:]]  # a CPU tensor's device index: None
    lib.vrt_error_string.argtypes = [ctypes.c_int]
    lib.vrt_error_string.restype = ctypes.c_char_p
    _build.load_library = lambda: lib
    fa.on_cpu = lambda t: False
    fa.stream_ptr = lambda device: ctypes.c_void_p(None)
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


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    asan = "--asan" in argv
    cases = [tuple(eval(c)) for c in argv if c != "--asan"] or CASES
    fa = use_library(build(asan))
    ok = all([check(fa, *case) for case in cases])
    print("all cases within their limits" if ok else "SOME CASES FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
