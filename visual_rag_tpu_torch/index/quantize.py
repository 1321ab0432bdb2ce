"""int8 storage: quantize a float index into int8 or int8_refined stores.

Port of the JAX package's seal-time quantization
(``visual_rag_tpu/index/store.py:35-107``, ``RaggedMultiVectors.build``
``:278-286``) with the numpy fallbacks of ``visual_rag_tpu/native.py:192-250``
as the definition of the rounding: codes are ``round(x / scale)`` (half to
even) clipped to [-127, 127]. The JAX package's native library computes
``round(x * (1 / scale))`` instead, which can land one code apart on a
handful of values; ``tests/test_torch_port_int8.py`` says how many.

- padded and single-vector stores: one f32 scale per row, ``max|row| / 127``
  (1 for an all-zero row);
- the ragged token store: one f32 scale per doc, ``max|doc| / 127``, which
  commutes with the row max and the query sum, so the kernels apply it once
  per doc;
- ``int8_refined``: the ragged store adds a per-row int4 residual
  ``r = x - s_doc * c8`` at ``rs = max|r| / 7``, packed two nibbles a byte
  (column 2j low, 2j+1 high, code + 8), zero bytes and a zero scale on rows
  outside every doc.

Everything here is plain torch on the tensors' own device.
"""

from __future__ import annotations

import dataclasses

import torch

from visual_rag_tpu_torch.index.store import (
    PaddedMultiVectors,
    RaggedMultiVectors,
    SealedIndex,
    SingleVectors,
    row_docs,
)

INT8_DTYPES = ("int8", "int8_refined")


def doc_scale_rows(offsets, lengths, doc_scales, n_rows: int) -> torch.Tensor:
    """Per-doc scales expanded to f32 [n_rows] (0 outside every doc)."""
    doc = row_docs(offsets, lengths, n_rows)
    return torch.where(doc >= 0, doc_scales.float()[doc.clamp(min=0)], 0.0)


def quantize_rows_int8(x: torch.Tensor):
    """Per-row symmetric int8: (codes int8 x.shape, scales f32 x.shape[:-1]),
    scale = max|row| / 127 (1 for a zero row)."""
    x = x.float()
    absmax = x.abs().amax(dim=-1)
    scales = torch.where(absmax > 0, absmax / 127.0, 1.0)
    codes = torch.round(x / scales[..., None]).clamp(-127, 127).to(torch.int8)
    return codes, scales


def quantize_per_doc(flat: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor):
    """Per-doc symmetric int8 of a ragged store: (codes int8 [N, dim],
    scales f32 [D]). The scale is ``max|doc| / 127`` taken in f64 and stored
    as f32 (the numpy fallback's arithmetic); rows outside every doc get
    zero codes."""
    flat = flat.float()
    doc = row_docs(offsets, lengths, flat.shape[0])
    real = doc >= 0
    m = torch.zeros(offsets.shape[0], dtype=torch.float32, device=flat.device)
    m.scatter_reduce_(0, doc[real], flat[real].abs().amax(dim=1), "amax")
    scales = torch.where(m > 0, (m.double() / 127.0).float(), 1.0)
    row_scale = torch.where(real, scales[doc.clamp(min=0)], 1.0)
    codes = torch.round(flat / row_scale[:, None]).clamp(-127, 127)
    return torch.where(real[:, None], codes, 0.0).to(torch.int8), scales


def residual_int4(flat: torch.Tensor, codes: torch.Tensor, doc_scales: torch.Tensor,
                  offsets: torch.Tensor, lengths: torch.Tensor):
    """Per-row int4 residual of per-doc int8 codes: (res4 uint8 [N, dim // 2],
    res_scales f32 [N]); JAX ``store.py:35-70``."""
    n, dim = flat.shape
    if dim % 2:
        raise ValueError("int8_refined requires an even dim")
    doc = row_docs(offsets, lengths, n)
    real = (doc >= 0).float()
    drows = torch.where(doc >= 0, doc_scales.float()[doc.clamp(min=0)], 0.0)
    r = flat.float() - drows[:, None] * codes.float()
    r = r * real[:, None]
    rs = (r.abs().amax(dim=1) / 7.0).clamp(min=1e-12)
    c4 = torch.round(r / rs[:, None]).clamp(-7, 7).to(torch.int16) + 8  # [1, 15]
    packed = (c4[:, 0::2] | (c4[:, 1::2] << 4)).to(torch.uint8)
    packed = packed * (real[:, None] > 0).to(torch.uint8)  # zero bytes off the docs
    return packed, rs * real


def quantize_index(index: SealedIndex, storage_dtype: str) -> SealedIndex:
    """An int8 or int8_refined copy of a float index, on the index's device.

    Ragged stores get per-doc scales (and the int4 residual for
    ``int8_refined``), padded and single-vector stores per-row scales, as
    ``IndexBuilder.seal`` does in the JAX package.
    """
    if storage_dtype not in INT8_DTYPES:
        raise ValueError(f"quantize_index makes {INT8_DTYPES}, not {storage_dtype!r}")
    stores = {}
    for name, st in index.stores.items():
        if getattr(st, "scales", None) is not None:
            raise ValueError(f"store {name!r} is already quantized")
        if isinstance(st, RaggedMultiVectors):
            codes, scales = quantize_per_doc(st.flat, st.offsets, st.lengths)
            res4 = res_scales = None
            if storage_dtype == "int8_refined":
                res4, res_scales = residual_int4(st.flat, codes, scales, st.offsets,
                                                 st.lengths)
            stores[name] = dataclasses.replace(st, flat=codes, scales=scales, res4=res4,
                                               res_scales=res_scales)
        elif isinstance(st, (PaddedMultiVectors, SingleVectors)):
            codes, scales = quantize_rows_int8(st.values)
            stores[name] = dataclasses.replace(st, values=codes, scales=scales)
        else:
            raise ValueError(f"store {name!r} has an unknown layout")
    return SealedIndex(stores=stores, manifest=index.manifest, storage_dtype=storage_dtype)
