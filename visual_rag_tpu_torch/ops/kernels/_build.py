"""Build and load the port's CUDA kernels: ``nvcc`` + ``ctypes``.

New in the port. Each ``csrc/*.cu`` file compiles in its own ``nvcc``
process, all started together, and one more ``nvcc`` call links the objects
into a shared library with a plain C interface, which :mod:`ctypes` loads.
This takes seconds; a build through ``torch.utils.cpp_extension`` (which
includes PyTorch's headers) takes minutes.

The library lands in ``build/kernels/`` beside the package, named after a
hash of the sources and flags, so an edit forces a rebuild. Only the
repository's sources are built; a failed build raises with nvcc's stderr.
Nothing is built at import: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
                           "-lineinfo"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process made, if any


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or under /usr/local/cuda/bin: the CUDA "
            "kernels cannot be built")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libvrt_kernels_{h.hexdigest()[:16]}.so"


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.vrt_rerank_candidates.argtypes = [
        i32, vp, i32, vp, vp, vp, i32, i32, i32, vp, i32, vp, i32, i64, vp, vp, vp]
    lib.vrt_rerank_candidates.restype = i32
    lib.vrt_rerank_candidates_dedup.argtypes = [
        i32, vp, i32, vp, vp, vp, i64, vp, i32, vp, i32, i32, i32, i32, vp, vp, vp, i32, vp, vp]
    lib.vrt_rerank_candidates_dedup.restype = i32
    lib.vrt_rerank_candidates_sweep.argtypes = [
        i32, vp, i32, vp, i32, vp, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.vrt_rerank_candidates_sweep.restype = i32
    lib.vrt_exhaustive_scores_packed.argtypes = [
        i32, vp, i32, vp, vp, i32, vp, vp, i32, vp, i32, i32, i32, i32, vp, vp, vp]
    lib.vrt_exhaustive_scores_packed.restype = i32
    lib.vrt_pooled_maxsim_scores_packed.argtypes = [
        i32, vp, i32, vp, vp, i32, i32, vp, i32, i32, i32, i32, i32, i32, vp, vp, vp, vp]
    lib.vrt_pooled_maxsim_scores_packed.restype = i32
    lib.vrt_flash_attention.argtypes = (
        [i32, i32, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32] + [i64] * 9
        + [i32, ctypes.c_float, vp])
    lib.vrt_flash_attention.restype = i32
    lib.vrt_error_string.argtypes = [i32]
    lib.vrt_error_string.restype = ctypes.c_char_p
    return lib


def load_library():
    """The kernel library, built on first use (thread-safe)."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            import time

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc, tag = find_nvcc(), f"{out.stem}.{os.getpid()}"
            t0 = time.perf_counter()
            jobs = []
            for src in sorted(CSRC.glob("*.cu")):
                obj = BUILD_DIR / f"{src.stem}.{tag}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                jobs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, _, proc in jobs]
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
            if all(rc == 0 for _, _, rc in logs):
                proc = subprocess.run(link, capture_output=True, text=True)
                logs.append((link, proc.stderr + proc.stdout, proc.returncode))
            for _, obj, _ in jobs:
                obj.unlink(missing_ok=True)
            failed = [(cmd, text, rc) for cmd, text, rc in logs if rc != 0]
            if failed:
                cmd, text, rc = failed[0]
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text}")
            build_seconds = time.perf_counter() - t0
            out.with_suffix(".log").write_text("".join(text for _, text, _ in logs))
            os.replace(tmp, out)
        _lib = _declare(ctypes.CDLL(str(out)))
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = load_library().vrt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
