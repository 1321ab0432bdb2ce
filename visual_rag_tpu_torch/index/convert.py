"""Carry a sealed JAX index across to the port: numpy arrays in, torch stores out.

New in the port. :func:`sealed_from_numpy` takes the arrays of a
``visual_rag_tpu.index.store.SealedIndex`` as numpy (the caller applies
``np.asarray`` on the JAX side, so this module needs no jax) and builds the
port's :class:`~visual_rag_tpu_torch.index.store.SealedIndex` from the same
bytes, so both packages score identical data.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from visual_rag_tpu_torch.device import resolve_device, storage_dtype as _torch_dtype
from visual_rag_tpu_torch.index.manifest import Manifest
from visual_rag_tpu_torch.index.store import (
    PaddedMultiVectors,
    RaggedMultiVectors,
    SealedIndex,
    SingleVectors,
)


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """Bit-exact numpy -> torch copy on ``device``.

    ``np.asarray`` of a JAX bf16 array has the ``ml_dtypes`` bfloat16 dtype,
    which ``torch.from_numpy`` refuses; its bits go across as uint16 and are
    reinterpreted as ``torch.bfloat16``.
    """
    a = np.require(a, requirements=["C", "W"])  # JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def sealed_from_numpy(
    stores: Mapping[str, Mapping[str, Any]],
    ids: List[str],
    payloads: List[Dict[str, Any]],
    storage_dtype: str,
    device,
) -> SealedIndex:
    """Port ``SealedIndex`` from the numpy arrays of a JAX one.

    ``stores`` maps each vector name to the arrays of its JAX store:
    ``{"flat", "offsets", "lengths", "max_len"}`` for a ragged store,
    ``{"values", "mask"}`` for a padded one and ``{"values"}`` for single
    vectors; int8 stores add ``scales``, and the ragged store of an
    ``int8_refined`` index ``res4`` and ``res_scales``. Every array goes
    across bit for bit. int8 codes without their scales are refused.
    """
    _torch_dtype(storage_dtype)  # raises on an unknown storage dtype
    dev = resolve_device(device)
    out = {}

    def opt(arrs, key, dtype=None):
        a = arrs.get(key)
        if a is None:
            return None
        return tensor_from_numpy(a if dtype is None else np.asarray(a, dtype), dev)

    for name, arrs in stores.items():
        vals = arrs["flat"] if "flat" in arrs else arrs["values"]
        if np.asarray(vals).dtype == np.int8 and arrs.get("scales") is None:
            raise ValueError(f"store {name!r} holds int8 codes without their scales")
        scales = opt(arrs, "scales", np.float32)
        if "flat" in arrs:
            out[name] = RaggedMultiVectors(
                flat=tensor_from_numpy(arrs["flat"], dev),
                offsets=tensor_from_numpy(np.asarray(arrs["offsets"], np.int32), dev),
                lengths=tensor_from_numpy(np.asarray(arrs["lengths"], np.int32), dev),
                max_len=int(arrs["max_len"]), scales=scales,
                res4=opt(arrs, "res4", np.uint8),
                res_scales=opt(arrs, "res_scales", np.float32))
        elif "mask" in arrs:
            out[name] = PaddedMultiVectors(
                values=tensor_from_numpy(arrs["values"], dev),
                mask=tensor_from_numpy(np.asarray(arrs["mask"], bool), dev), scales=scales)
        else:
            out[name] = SingleVectors(values=tensor_from_numpy(arrs["values"], dev),
                                      scales=scales)
    return SealedIndex(stores=out, manifest=Manifest(ids, payloads),
                       storage_dtype=storage_dtype)
