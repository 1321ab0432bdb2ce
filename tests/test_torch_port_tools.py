"""The parsers of ``visual_rag_tpu_torch/tools/sass_diff.py`` on cuobjdump and
ptxas text in the formats CUDA 12 prints; the source rewrite of
``tools/emulate_kernels.py`` on the launches and shared memory of ``csrc/``;
the emulator's models of the tensor-core building blocks
(``tools/cuda_emu.h``: ``mma.sync`` m16n8k16 in bf16, ``ldmatrix`` plain and
``.trans``, ``cp.async`` with zero-fill) against numpy on one warp, element
by element, with the PTX ISA's fragment layout written out here, and
``csrc/flash_mma.cuh``'s repacking of a logit tile's C fragments into the A
fragment of the next product as a bf16 pair hi + lo; the emulator itself on
ColQwen2.5's head dims and on a split head group (the CUDA sources of the lse
forward, B4 and B5 run under g++ against their plain versions), the bf16
K10 (serving and with lse) on the tensor-core body at Dh 64 and 72 in this
process, the pooled stage-1 (``csrc/pooled_stage1.cu``) through its
wrapper on bf16, f16 and int8 stores against its plain version, and K3's
tensor-core body (``csrc/maxsim_dedup_mma.cu``) through
``rerank_candidates_dedup`` on the same stores against its plain version,
and its refusal of runs wider than its shared arrays; ``chip_smoke.strict_oracle``
running check 2 once, at the tolerance its wide side's rerank asks for."""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from visual_rag_tpu_torch.tools.emulate_kernels import (
    DEDUP_CASES,
    MOE_CASES,
    STAGE1_CASES,
    emulated_source,
    write_sources,
)
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
    # kernel; six shared buffers: K10, B4 and B5, each in f32 and in bf16
    launches, shared = text.count("<<<"), text.count("extern __shared__")
    assert launches == 2 and shared == 6
    assert "launch_kernel(flash_bwd_dkv_reduce_kernel," in text
    got = emulated_source(text)
    assert "<<<" not in got and "extern __shared__" not in got
    assert got.count("emu_launch(") == launches
    assert got.count("float* smem = emu_smem;") == shared
    assert ("emu_launch(dim3((cells + 127) / 128), 128, 0, seg_tile_range_kernel, seg, t_len,"
            in got)
    assert "emu_launch(dim3(grid), NT, smem, kernel, args...);" in got


PROBE = r"""
#include "cuda_emu.h"
#include "flash_mma.cuh"

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

// lane l's C fragments of two n8 tiles (c[8l..8l+3], c[8l+4..8l+7]) as the A fragment of
// one k-step, hi and lo; then d = hi . b + lo . b, as K10's O += P V
static void repack_kernel(const float* c, const uint32_t* b, uint32_t* hi, uint32_t* lo,
                          float* d) {
  const int l = threadIdx.x;
  const float c0[4] = {c[8 * l], c[8 * l + 1], c[8 * l + 2], c[8 * l + 3]};
  const float c1[4] = {c[8 * l + 4], c[8 * l + 5], c[8 * l + 6], c[8 * l + 7]};
  uint32_t h[4], o[4];
  vrt_fa::c_to_a_split(c0, c1, h, o);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16_16816(acc, h, b[2 * l], b[2 * l + 1]);
  mma_bf16_16816(acc, o, b[2 * l], b[2 * l + 1]);
  for (int i = 0; i < 4; ++i) {
    hi[4 * l + i] = h[i];
    lo[4 * l + i] = o[i];
    d[4 * l + i] = acc[i];
  }
}

extern "C" void run_repack(const float* c, const uint32_t* b, uint32_t* hi, uint32_t* lo,
                           float* d) {
  emu_launch(dim3(1), 32, 0, repack_kernel, c, b, hi, lo, d);
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
    """The models of ``tools/cuda_emu.h`` and the tile helpers of
    ``csrc/flash_mma.cuh`` over them, behind a small C interface, built with g++."""
    if shutil.which("g++") is None:
        pytest.skip("the emulator's models compile with g++")
    out = tmp_path_factory.mktemp("emu_models")
    write_sources(out / "src")
    (out / "probe.cpp").write_text(PROBE)
    tools = Path(__file__).resolve().parents[1] / "visual_rag_tpu_torch" / "tools"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-I", str(out / "src"),
                    "-I", str(tools), "-o", str(out / "probe.so"), str(out / "probe.cpp")],
                   check=True, timeout=120)
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


def _bf16_rne(x):
    """float32 values rounded to bf16 (nearest, ties to even), as float32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16).astype(np.uint32)
    return bits.view(np.float32)


def test_emulated_logit_repacking_is_the_a_fragment_as_hi_and_lo(emu_models):
    """``c_to_a_split`` (``csrc/flash_mma.cuh``): a 16 x 16 f32 tile P handed
    to the lanes as the C fragments of two n8 tiles (columns 0-7, 8-15; lane
    (g, t) holds rows g, g + 8 and columns 2t, 2t + 1 of each) comes out, lane
    by lane, as the A fragment of one k-step in the PTX layout, with hi =
    bf16(P) and lo = bf16(P - hi) bit for bit; and hi . B + lo . B through the
    emulated ``mma`` is P @ B within 2**-16 of sum |P| |B| (one bf16 rounding
    of P alone is 2**-9). P spans 1e-8..1e2, with a few values that bf16 holds
    exactly (lo = 0) and zeros."""
    rng = np.random.default_rng(3)
    p = (rng.standard_normal((16, 16)) * 10.0 ** rng.uniform(-8, 2, (16, 16))).astype(np.float32)
    p[0, :4] = [1.0, 0.0, -0.375, 2.0 ** -20]
    b = _bf16_rne(rng.standard_normal((16, 8)).astype(np.float32))
    c = np.zeros((32, 8), np.float32)
    frag_b = np.zeros((32, 2), np.uint32)
    bb = _bf16_bits(b)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for tile in range(2):
            cols = 8 * tile + 2 * t
            c[lane, 4 * tile:4 * tile + 4] = (p[g, cols], p[g, cols + 1], p[g + 8, cols],
                                              p[g + 8, cols + 1])
        for reg, row in enumerate((2 * t, 2 * t + 8)):
            frag_b[lane, reg] = bb[row, g] | bb[row + 1, g] << 16
    hi, lo = np.zeros((32, 4), np.uint32), np.zeros((32, 4), np.uint32)
    d = np.zeros((32, 4), np.float32)
    emu_models.run_repack(_np_ptr(c), _np_ptr(frag_b), _np_ptr(hi), _np_ptr(lo), _np_ptr(d))
    p_hi = _bf16_rne(p)
    p_lo = _bf16_rne(p - p_hi)
    hb, lb = _bf16_bits(p_hi), _bf16_bits(p_lo)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg, (row, col) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                          (g + 8, 2 * t + 8))):
            assert hi[lane, reg] == hb[row, col] | hb[row, col + 1] << 16, (lane, reg)
            assert lo[lane, reg] == lb[row, col] | lb[row, col + 1] << 16, (lane, reg)
    got = np.zeros((16, 8), np.float32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        got[g, 2 * t], got[g, 2 * t + 1], got[g + 8, 2 * t], got[g + 8, 2 * t + 1] = d[lane]
    p64, b64 = p.astype(np.float64), b.astype(np.float64)
    assert (np.abs(got - p64 @ b64) <= 2.0 ** -16 * (np.abs(p64) @ np.abs(b64))).all()
    assert not (np.abs(_bf16_rne(p).astype(np.float64) @ b64 - p64 @ b64)
                <= 2.0 ** -16 * (np.abs(p64) @ np.abs(b64))).all()


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


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    """The CUDA sources of ``csrc/`` built with g++ against ``tools/cuda_emu.h``
    (``emulate_kernels.build``), in a directory of this module's own."""
    if shutil.which("g++") is None:
        pytest.skip("the emulator compiles the CUDA sources with g++")
    from visual_rag_tpu_torch.tools.emulate_kernels import build

    return build(asan=False, out=tmp_path_factory.mktemp("emu_k10"))


def _use_emulated(emulated_library, monkeypatch):
    """``use_library`` on the emulated build: the wrappers of K10, the pooled
    stage-1, K3 and K11 take CPU tensors to it until the test ends."""
    from visual_rag_tpu_torch.ops.kernels import _build
    from visual_rag_tpu_torch.ops.kernels import flash_attention as fa
    from visual_rag_tpu_torch.ops.kernels import maxsim_rerank as mr
    from visual_rag_tpu_torch.ops.kernels import moe_experts as me
    from visual_rag_tpu_torch.ops.kernels import prefetch_topk as pt
    from visual_rag_tpu_torch.tools.emulate_kernels import use_library

    monkeypatch.setattr(_build, "load_library", _build.load_library)  # undone after the test
    for module in (fa, pt, mr, me):
        monkeypatch.setattr(module, "on_cpu", module.on_cpu)
        monkeypatch.setattr(module, "stream_ptr", module.stream_ptr)
    use_library(emulated_library)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", [64, 72])
def test_emulated_bf16_k10_tensor_core_body(emulated_library, monkeypatch, dh, causal):
    """The bf16 K10 from the CUDA source (its tensor-core body, 4 warps of 16
    rows, ``mma`` tiles, P as hi + lo in registers, a two-stage ``cp.async``
    ring) at Dh 64 and Dh 72 (padded to 80 by zero-filled copies): T 150 (not
    a multiple of 64), 4 heads on 2 kv heads read in place from strided
    views, two segments with pads, and one row in a segment of its own,
    whose only key is itself. The serving output holds ``K10_TOL`` against
    the plain version, the lse forward's lse ``LSE_ATOL`` with the same -inf
    rows, its output equals the serving one bit for bit, two calls are
    bit-equal, and the lone row's output is its v exactly (P = 1 is hi = 1,
    lo = 0)."""
    import torch

    from chip_smoke import K10_TOL, LSE_ATOL
    from visual_rag_tpu_torch.ops.kernels import flash_attention as fa

    _use_emulated(emulated_library, monkeypatch)
    rng = np.random.default_rng(dh + causal)
    b, t, hq, hkv, lone = 2, 150, 4, 2, 77
    qkv = torch.from_numpy(rng.standard_normal((b, t, hq + 2 * hkv, dh)).astype(np.float32))
    qkv = qkv.to(torch.bfloat16)
    q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    seg = np.zeros((b, t), np.int32)
    seg[0, :140] = 1 + (np.arange(140) >= 60)
    seg[1, :] = 1
    seg[0, lone] = 9  # its only allowed key is itself
    seg = torch.from_numpy(seg)
    before = (fa.flash_attention.launches, fa.flash_attention_fwd.launches)
    with torch.no_grad():
        out, again = (fa.flash_attention(q, k, v, seg, causal=causal) for _ in range(2))
    out_lse, lse = fa.flash_attention_fwd(q, k, v, seg, causal=causal)
    assert (fa.flash_attention.launches, fa.flash_attention_fwd.launches) == (
        before[0] + 2, before[1] + 1)
    want, lse_p = fa.flash_attention_fwd_plain(q, k, v, seg, causal=causal)
    rtol, atol = K10_TOL["bf16"]
    diff = (out.float() - want.float()).abs()
    assert (diff <= atol + rtol * want.float().abs()).all(), float(diff.max())
    assert torch.equal(out, again) and torch.equal(out, out_lse)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_p))
    fin = torch.isfinite(lse_p)
    assert float((lse - lse_p)[fin].abs().max()) <= LSE_ATOL
    assert torch.equal(out[0, lone], v[0, lone].repeat_interleave(hq // hkv, 0))


@pytest.mark.parametrize("case", STAGE1_CASES, ids=["-".join(map(str, c)) for c in STAGE1_CASES])
def test_emulated_pooled_stage1_matches_plain(emulated_library, monkeypatch, case):
    """The pooled stage-1 from its CUDA source (``mma`` tiles in bf16 and
    f16, int8 codes widened to bf16 in shared memory, the ``cp.async`` ring
    with its mask words read from a 4-byte boundary) through
    ``pooled_stage1_scores``: 13 to 200 docs (not multiples of the 32-doc
    tile, odd and even), two query tiles, P 1 to 10 with holes, blocks that
    walk several doc tiles (2 or 4 SMs), int8 with and without scales;
    within 1e-5 of the plain version, empty docs 0, two calls bit-equal."""
    from visual_rag_tpu_torch.tools.emulate_kernels import check_stage1

    _use_emulated(emulated_library, monkeypatch)
    assert check_stage1(*case)


@pytest.mark.parametrize("case", DEDUP_CASES, ids=["-".join(map(str, c)) for c in DEDUP_CASES])
def test_emulated_dedup_matches_plain(emulated_library, monkeypatch, case):
    """K3's tensor-core body from its CUDA source (``mma`` tiles in bf16 and
    f16, int8 codes widened to bf16 in shared memory, the ``cp.async`` ring
    across doc boundaries, the run table, the warp grid of one to 24 query
    tiles, the row max on the fragments, the fold) through
    ``rerank_candidates_dedup``: docs of 0, 1, 128, 129 and up to 299 rows,
    queries of 3 to 130 rows with masked tails, runs of one pair up to the
    most a run holds, -1 and out-of-range candidates, blocks that walk many
    runs (2 to 4 SMs), per-doc scales; within ``ATOL`` (1e-3) of
    ``rerank_candidates_dedup_ref``, NEG_INF where it has it, two calls
    bit-equal, ``mma_launches`` counted."""
    from visual_rag_tpu_torch.tools.emulate_kernels import check_dedup

    _use_emulated(emulated_library, monkeypatch)
    b, k, d, nq, dtype, scaled, sms, spread = case
    assert check_dedup(b, k, d, nq, dtype, scaled, spread, sms)


def test_emulated_dedup_refuses_runs_past_its_shared_arrays(emulated_library, monkeypatch):
    """K3's tensor-core body sizes its shared arrays for runs of at most 24
    query tiles and 16 pairs, and ``dedup_run_pairs`` cuts the layout so. Its
    C entry takes the run size the layout was cut with and refuses one past
    those arrays before the launch: a layout cut at 16 pairs of 3 tiles (33
    query rows) raises, and leaves the launch counts as they were."""
    from visual_rag_tpu_torch.ops.kernels import maxsim_rerank as mr
    from visual_rag_tpu_torch.tools.emulate_kernels import dedup_inputs

    _use_emulated(emulated_library, monkeypatch)
    args = dedup_inputs(20, 9, 6, 33, "bf16", False, "heavy")
    assert mr.dedup_run_pairs(args[0].dtype, 128, 33) == 8
    monkeypatch.setattr(mr, "dedup_run_pairs", lambda dtype, dim, nq: mr.RUN_PAIRS)
    before = (mr.rerank_candidates_dedup.launches, mr.rerank_candidates_dedup.mma_launches)
    with pytest.raises(RuntimeError, match="rerank_candidates_dedup launch"):
        mr.rerank_candidates_dedup(*args)
    assert (mr.rerank_candidates_dedup.launches,
            mr.rerank_candidates_dedup.mma_launches) == before


@pytest.mark.parametrize("mma", [False, True])
def test_chip_smoke_strict_oracle_runs_once_at_the_wide_sides_tolerance(monkeypatch, mma):
    """``chip_smoke.strict_oracle`` runs check 2 once: one ``single_full`` and
    one ``two_stage`` search, compared at tolerance 0, or at 1e-4 where the
    wide side launched K3's tensor-core body (its ``mma_launches`` grew).
    The wide side's scores here are shifted by 5e-5, so the tolerance it
    chose decides the answer."""
    from chip_smoke import strict_oracle
    from visual_rag_tpu_torch import RetrievalEngine, synthetic_index
    from visual_rag_tpu_torch.ops.kernels.maxsim_rerank import rerank_candidates_dedup

    index = synthetic_index(60, min_tokens=8, max_tokens=40, pooled_rows=4,
                            storage_dtype="float32", seed=3, device="cpu")
    engine = RetrievalEngine(index)
    search, calls = engine.search_embedded_batch, []

    def counted(queries, mode, **kw):
        calls.append(mode)
        hits = search(queries, mode=mode, **kw)
        if mode != "two_stage":
            return hits
        monkeypatch.setattr(rerank_candidates_dedup, "mma_launches",
                            rerank_candidates_dedup.mma_launches + mma)
        return [[dict(h, score_final=h["score_final"] + 5e-5) for h in row] for row in hits]

    monkeypatch.setattr(engine, "search_embedded_batch", counted)
    rng = np.random.default_rng(3)
    queries = [rng.standard_normal((int(n), 128)).astype(np.float32) for n in (5, 9, 12)]
    assert strict_oracle(engine, queries, index.num_docs) == (mma, 1e-4 if mma else 0.0)
    assert calls == ["single_full", "two_stage"]


@pytest.mark.parametrize("case", MOE_CASES, ids=["-".join(map(str, c)) for c in MOE_CASES])
def test_emulated_moe_experts_matches_plain(emulated_library, monkeypatch, case):
    """K11 from its CUDA source (the gate and up ``mma`` tiles sharing one
    pass and the SiLU x up epilogue, the down tiles, the three-stage
    ``cp.async`` ring with its zero-filled rows past an expert's last row,
    the binary search of the tile starts, the fixed-order combine) through
    ``moe_experts``: a skewed layout (one expert in every token's choice,
    several experts with no token, part-full tiles), a uniform one over two
    column blocks, and one token; within two bf16 roundings of the plain
    version, two calls bit-equal, one launch counted a call."""
    from visual_rag_tpu_torch.tools.emulate_kernels import check_moe

    _use_emulated(emulated_library, monkeypatch)
    assert check_moe(*case)
