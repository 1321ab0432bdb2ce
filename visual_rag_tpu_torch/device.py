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
    # int8 codes with f32 scales beside them; int8_refined adds the int4
    # residual sidecar to the ragged token store (index/quantize.py)
    "int8": torch.int8,
    "int8_refined": torch.int8,
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
    """Torch dtype of a storage dtype name (``index/store.py:32`` of the JAX
    package): the element type of the stored values, int8 for both int8
    dtypes."""
    if name not in STORAGE_DTYPES:
        raise ValueError(f"unknown storage dtype {name!r} (have: {sorted(STORAGE_DTYPES)})")
    return STORAGE_DTYPES[name]
