"""The parsers of ``visual_rag_tpu_torch/tools/sass_diff.py`` on cuobjdump and
ptxas text in the formats CUDA 12 prints; the source rewrite of
``tools/emulate_kernels.py`` on the launches and shared memory of ``csrc/``;
the emulator's models of the tensor-core building blocks
(``tools/cuda_emu.h``: ``mma.sync`` m16n8k16 in bf16, ``ldmatrix`` plain and
``.trans``, ``cp.async`` with zero-fill) against numpy on one warp, element
by element, with the PTX ISA's fragment layout written out here; the
emulator itself on ColQwen2.5's head dims and on a split head group (the
CUDA sources of the lse forward, B4 and B5 run under g++ against their plain
versions)."""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from visual_rag_tpu_torch.tools.emulate_kernels import emulated_source
from visual_rag_tpu_torch.tools.sass_diff import ptxas_by_kernel, sass_by_kernel

SASS = """
Fatbin elf code:
================
arch = sm_90a

\t\tFunction : _Z1kPf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
                                                                  /* 0x000e220000000800 */
        /*0010*/                   EXIT ;                         /* 0x000000000000794d */
\t\tFunction : _Z1gPi
        /*0000*/                   EXIT ;                         /* 0x000000000000794d */
"""

PTXAS = """ptxas info    : Compiling entry function '_Z1kPf' for 'sm_90a'
ptxas info    : Function properties for _Z1kPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 124 registers, used 1 barriers
"""


def test_sass_by_kernel_drops_addresses_and_encodings():
    got = sass_by_kernel(SASS)
    assert list(got) == ["_Z1kPf", "_Z1gPi"]
    assert got["_Z1kPf"] == ['.headerflags\t@"EF_CUDA_SM90"', "LDC R1, c[0x0][0x28] ;", "EXIT ;"]
    assert got["_Z1gPi"] == ["EXIT ;"]
    moved = SASS.replace("/*0010*/", "/*0a40*/").replace("0x000000000000794d", "0x1")
    assert sass_by_kernel(moved) == got


def test_ptxas_by_kernel_keeps_registers_and_spills():
    assert ptxas_by_kernel(PTXAS) == {"_Z1kPf": [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 124 registers, used 1 barriers"]}


def test_emulated_source_rewrites_every_launch_and_shared_buffer():
    csrc = Path(__file__).resolve().parents[1] / "visual_rag_tpu_torch" / "csrc"
    text = "\n".join((csrc / name).read_text() for name in (
        "flash_common.cuh", "mma_tiles.cuh", "flash_attention.cu", "flash_attention_bwd.cu"))
    # two launch sites: launch_kernel (K10, B4, B5 and B4's reduction) and the range table's
    # kernel; five shared buffers: K10, then B4 and B5 in f32 and in bf16
    launches, shared = text.count("<<<"), text.count("extern __shared__")
    assert launches == 2 and shared == 5
    assert "launch_kernel(flash_bwd_dkv_reduce_kernel," in text
    got = emulated_source(text)
    assert "<<<" not in got and "extern __shared__" not in got
    assert got.count("emu_launch(") == launches
    assert got.count("float* smem = emu_smem;") == shared
    assert ("emu_launch(dim3((cells + 127) / 128), 128, 0, seg_tile_range_kernel, seg, t_len,"
            in got)
    assert "emu_launch(dim3(grid), THREADS, smem, kernel, args...);" in got


PROBE = r"""
#include "cuda_emu.h"

static void mma_kernel(const uint32_t* a, const uint32_t* b, const float* c, float* d) {
  const int l = threadIdx.x;
  const uint32_t fa[4] = {a[4 * l], a[4 * l + 1], a[4 * l + 2], a[4 * l + 3]};
  float acc[4] = {c[4 * l], c[4 * l + 1], c[4 * l + 2], c[4 * l + 3]};
  mma_bf16_16816(acc, fa, b[2 * l], b[2 * l + 1]);
  for (int i = 0; i < 4; ++i) d[4 * l + i] = acc[i];
}

// lane l gives the address of row l of m (row stride ld), as ldmatrix's row addresses
static void ldsm_kernel(const uint16_t* m, int ld, int kind, uint32_t* out) {
  const int l = threadIdx.x;
  uint32_t r4[4] = {0, 0, 0, 0}, r2[2] = {0, 0};
  if (kind == 0) ldsm_x4(r4, m + l * ld);
  if (kind == 1) ldsm_x4_trans(r4, m + l * ld);
  if (kind == 2) ldsm_x2_trans(r2, m + l * ld);
  for (int i = 0; i < 4; ++i) out[4 * l + i] = kind == 2 ? (i < 2 ? r2[i] : 0) : r4[i];
}

extern "C" void run_mma(const uint32_t* a, const uint32_t* b, const float* c, float* d) {
  emu_launch(dim3(1), 32, 0, mma_kernel, a, b, c, d);
}

extern "C" void run_ldsm(const uint16_t* m, int ld, int kind, uint32_t* out) {
  emu_launch(dim3(1), 32, 0, ldsm_kernel, m, ld, kind, out);
}

extern "C" void run_cp_async(void* dst, const void* src, int bytes, int full) {
  if (bytes == 16) cp_async_16(dst, src, full);
  else cp_async_4(dst, src, full);
  cp_async_commit();
  cp_async_wait<0>();
}
"""


@pytest.fixture(scope="module")
def emu_models(tmp_path_factory):
    """The models of ``tools/cuda_emu.h`` behind a small C interface, built with g++."""
    if shutil.which("g++") is None:
        pytest.skip("the emulator's models compile with g++")
    out = tmp_path_factory.mktemp("emu_models")
    (out / "probe.cpp").write_text(PROBE)
    tools = Path(__file__).resolve().parents[1] / "visual_rag_tpu_torch" / "tools"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-I", str(tools), "-o",
                    str(out / "probe.so"), str(out / "probe.cpp")], check=True, timeout=120)
    return ctypes.CDLL(str(out / "probe.so"))


def _np_ptr(x):
    return ctypes.c_void_p(x.ctypes.data)


def _bf16_bits(x):
    """The bf16 bit patterns of float32 values that bf16 holds exactly."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    assert not (bits & 0xFFFF).any()
    return (bits >> 16).astype(np.uint32)


def test_emulated_mma_matches_numpy_on_one_warp(emu_models):
    """``mma_bf16_16816`` on random bf16 A (16 x 16), B (16 x 8) and f32 C,
    handed to the 32 lanes in the PTX ISA's layout ("Matrix fragments for
    mma.m16n8k16", g = lane >> 2, t = lane & 3, the lower column or row in a
    register's low half), against A @ B + C in numpy: every element of D
    read back through the same layout. The values are multiples of 1/16
    below 8 in magnitude, so every sum is exact and the check is equality."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.integers(-127, 128, shape).astype(np.float32) / 16
               for shape in ((16, 16), (16, 8), (16, 8)))
    ab, bb = _bf16_bits(a), _bf16_bits(b)
    frag_a = np.zeros((32, 4), np.uint32)
    frag_b = np.zeros((32, 2), np.uint32)
    frag_c = np.zeros((32, 4), np.float32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg, (row, col) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                          (g + 8, 2 * t + 8))):
            frag_a[lane, reg] = ab[row, col] | ab[row, col + 1] << 16
        for reg, row in enumerate((2 * t, 2 * t + 8)):
            frag_b[lane, reg] = bb[row, g] | bb[row + 1, g] << 16
        frag_c[lane] = c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t], c[g + 8, 2 * t + 1]
    frag_d = np.zeros((32, 4), np.float32)
    emu_models.run_mma(_np_ptr(frag_a), _np_ptr(frag_b), _np_ptr(frag_c), _np_ptr(frag_d))
    d = np.zeros((16, 8), np.float32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        d[g, 2 * t], d[g, 2 * t + 1], d[g + 8, 2 * t], d[g + 8, 2 * t + 1] = frag_d[lane]
    want = a.astype(np.float64) @ b.astype(np.float64) + c
    assert np.array_equal(d, want.astype(np.float32))


@pytest.mark.parametrize("kind,n,trans", [(0, 4, False), (1, 4, True), (2, 2, True)])
def test_emulated_ldmatrix_matches_the_ptx_layout(emu_models, kind, n, trans):
    """``ldsm_x4``, ``ldsm_x4_trans`` and ``ldsm_x2_trans``: lanes 8i..8i+7
    give the rows of matrix i (here rows 8i.. of a 32-row bf16 array of row
    stride 24); register i of lane (g, t) holds row g, columns 2t and 2t+1 of
    matrix i, or with .trans rows 2t and 2t+1 of column g."""
    rng = np.random.default_rng(kind)
    ld = 24
    m = rng.integers(0, 1 << 16, (32, ld)).astype(np.uint16)
    out = np.zeros((32, 4), np.uint32)
    emu_models.run_ldsm(_np_ptr(m), ld, kind, _np_ptr(out))
    mm = m.astype(np.uint32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            if i >= n:
                want = 0
            elif trans:
                want = mm[8 * i + 2 * t, g] | mm[8 * i + 2 * t + 1, g] << 16
            else:
                want = mm[8 * i + g, 2 * t] | mm[8 * i + g, 2 * t + 1] << 16
            assert out[lane, i] == want, (lane, i)


@pytest.mark.parametrize("nbytes", [4, 16])
def test_emulated_cp_async_copies_or_zero_fills(emu_models, nbytes):
    """``cp_async_16`` and ``cp_async_4``: the bytes of src where src-size is
    the copy's size, zeros where it is 0."""
    src = np.arange(1, 17, dtype=np.uint8)
    dst = np.full(16, 0xAB, np.uint8)
    emu_models.run_cp_async(_np_ptr(dst), _np_ptr(src), nbytes, 1)
    assert (dst[:nbytes] == src[:nbytes]).all() and (dst[nbytes:] == 0xAB).all()
    emu_models.run_cp_async(_np_ptr(dst), _np_ptr(src), nbytes, 0)
    assert (dst[:nbytes] == 0).all() and (dst[nbytes:] == 0xAB).all()


def test_emulated_kernels_match_plain_at_colqwens_head_dims():
    """Dh 80 over 64-row segments (window-like) with pads and T not a multiple
    of 64, and Dh 128 with 4 heads on 2, causal: K10, its lse forward, B4
    and B5 from the CUDA sources in f32 and bf16, each within chip_smoke.py's
    limits (``K10_TOL``, ``LSE_ATOL``, ``BWD_TOL``)."""
    if shutil.which("g++") is None:
        pytest.skip("the emulator compiles the CUDA sources with g++")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "visual_rag_tpu_torch" / "tools" / "emulate_kernels.py"),
         "80,200,2,2,False,64", "128,90,4,2,True,None"],
        capture_output=True, text=True, cwd=root, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = [x for x in out.stdout.splitlines() if x.startswith("Dh ")]
    assert len(lines) == 4 and all(x.endswith("ok") for x in lines), lines
    for x in lines:
        assert all(name in x for name in ("lse forward vs serving", "lse", "dq", "dk", "dv"))
    assert "all cases within their limits" in out.stdout


def test_emulated_backward_splits_a_head_group():
    """Dh 256 with 8 heads on one kv head (ColPali's text) at T 70: bf16 B4
    splits the group into 8 slices (6 blocks are far from two waves of 132
    SMs), sums each slice into the scratch and reduces; K10, its lse forward,
    B4 and B5 from the CUDA sources in f32 and bf16 within chip_smoke.py's
    limits."""
    if shutil.which("g++") is None:
        pytest.skip("the emulator compiles the CUDA sources with g++")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "visual_rag_tpu_torch" / "tools" / "emulate_kernels.py"),
         "256,70,8,1,False,None"],
        capture_output=True, text=True, cwd=root, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = [x for x in out.stdout.splitlines() if x.startswith("Dh ")]
    assert len(lines) == 2 and all(x.endswith("ok") for x in lines), lines
    assert "f32:" in lines[0] and "B4 in 1 slices" in lines[0]
    assert "bf16:" in lines[1] and "B4 in 8 slices" in lines[1]
