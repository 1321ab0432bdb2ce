"""The parsers of ``visual_rag_tpu_torch/tools/sass_diff.py`` on cuobjdump and
ptxas text in the formats CUDA 12 prints; the source rewrite of
``tools/emulate_kernels.py`` on the launches and shared memory of ``csrc/``;
the emulator itself on ColQwen2.5's head dims (the CUDA sources of the lse
forward, B4 and B5 at Dh 80 and 128 run under g++ against their plain
versions)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

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
        "flash_common.cuh", "flash_attention.cu", "flash_attention_bwd.cu"))
    launches, shared = text.count("<<<"), text.count("extern __shared__")
    assert launches == 2 and shared == 3
    got = emulated_source(text)
    assert "<<<" not in got and "extern __shared__" not in got
    assert got.count("emu_launch(") == launches
    assert got.count("float* smem = emu_smem;") == shared
    assert ("emu_launch(dim3((cells + 127) / 128), 128, 0, seg_tile_range_kernel, seg, t_len,"
            in got)
    assert "emu_launch(dim3(grid), THREADS, smem, kernel, args...);" in got


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
