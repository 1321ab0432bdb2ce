"""Device and storage-dtype helpers for the port.

New in the port (the JAX package leaves placement to ``jax.default_backend``).
The rule here: nothing picks a device by itself. Every entry point takes the
device its caller names; the CPU is used only when a caller passes
``device="cpu"``, as the tests do, so a run that meant to use the card can
never fall back to the CPU without saying so.
"""

from __future__ import annotations

import torch

STORAGE_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device must exist."""
    if device is None:
        raise ValueError("pass a device explicitly ('cuda', 'cuda:0' or 'cpu')")
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev


def require_cuda() -> None:
    """Raise unless PyTorch sees a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this PyTorch build or machine has no usable GPU "
            f"(torch {torch.__version__}, built for CUDA {torch.version.cuda}); "
            "pass device='cpu' to run the plain PyTorch versions instead")


def storage_dtype(name: str) -> torch.dtype:
    """Torch dtype of a float storage dtype name (int8 stores come later)."""
    if name not in STORAGE_DTYPES:
        raise NotImplementedError(
            f"storage dtype {name!r} is not ported yet (float32, bfloat16 and "
            "float16 are; int8 and int8_refined are ROADMAP A6)")
    return STORAGE_DTYPES[name]
