"""Argument checks, ctypes helpers and constants shared by the kernel wrappers.

New in the port. A wrapper runs its plain PyTorch version for a CPU
tensor and launches its CUDA kernel for a CUDA tensor; these checks stand
between a CUDA tensor and the kernel, and raise on anything it does not
take rather than fall back.
"""

from __future__ import annotations

import ctypes

import torch

# dtype codes of the kernels' C interface (csrc/*.cu)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}
# the score of padding candidates, empty docs and masked rows (csrc/maxsim_common.cuh)
NEG_INF = -1e30


def ceil32(n: int) -> int:
    """``n`` rounded up to a multiple of 32: a doc's rows in a store's
    32-row-aligned blocks."""
    return ((int(n) + 31) // 32) * 32


def compute_dtype(store_dtype: torch.dtype) -> torch.dtype:
    """The dtype queries are rounded to against a store: the store's own for
    float stores, bf16 for int8 codes (JAX ``sharded.py:304-305``,
    ``maxsim_rerank.py:171``, ``prefetch_topk.py:209``)."""
    return torch.bfloat16 if store_dtype == torch.int8 else store_dtype


def on_cpu(t: torch.Tensor) -> bool:
    """Plain version for CPU tensors; the kernel for CUDA ones; else raise."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}: the kernels run on CUDA")
    return False


def check_store(flat: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor) -> None:
    if flat.dtype not in DTYPE_CODES:
        raise ValueError(f"store dtype {flat.dtype} not supported by the kernels "
                         "(float32, bfloat16, float16, int8)")
    if flat.dim() != 2 or not flat.is_contiguous():
        raise ValueError("flat must be a contiguous [rows, dim] tensor")
    if flat.shape[1] % 8 or flat.data_ptr() % 16:
        raise ValueError("flat rows must be 16-byte aligned: dim % 8 == 0 and an aligned base")
    for name, t in (("offsets", offsets), ("lengths", lengths)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 [D] tensor")
        if t.device != flat.device:
            raise ValueError(f"{name} is on {t.device}, flat on {flat.device}")
    if offsets.shape != lengths.shape:
        raise ValueError("offsets and lengths must have the same length")


def check_scales(doc_scales, flat: torch.Tensor, offsets: torch.Tensor) -> None:
    if doc_scales is None:
        return
    if (doc_scales.dtype != torch.float32 or doc_scales.shape != offsets.shape
            or not doc_scales.is_contiguous() or doc_scales.device != flat.device):
        raise ValueError("doc_scales must be a contiguous float32 [D] tensor beside flat")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
