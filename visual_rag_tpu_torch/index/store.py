"""Device-resident vector stores: padded, ragged and single-vector layouts.

Port of ``visual_rag_tpu/index/store.py:111-397`` for every storage dtype:
float32, bfloat16, float16, and int8 codes with f32 scales beside them
(per row on the padded and single-vector stores, per doc on the ragged
store). ``int8_refined`` is int8 plus the ragged store's int4 residual
sidecar ``res4``/``res_scales``. Each store holds its tensors on one device;
``index/quantize.py`` makes the int8 stores from float ones.

The byte layout is the JAX package's, exactly: the ragged store's doc
blocks start on 32-row boundaries, and ``flat`` ends with a tail pad of
``ceil32(max_len)`` rows. The port's kernels read only the rows ``< len`` of
each doc, so they need neither; the layout is kept so that a store carried
across from the JAX package (``index/convert.py``) is the same bytes.

The ``build`` classmethods (``store.py:148-176, 249-297, 332-344``) seal
float stores from host matrices: rows are cosine-normalized on the host in
numpy as ``native.pack_aligned``'s numpy fallback and ``_normalize_rows`` do
it (``max(norm, 1e-12)``), cast to the storage dtype (bf16 and f16 rounded
to nearest even) and moved to the device. int8 stores are made from a float
one by ``index/quantize.py::quantize_index``, as ``IndexBuilder.seal`` does.
The streaming seal (``index/stream.py``) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from visual_rag_tpu_torch.device import resolve_device
from visual_rag_tpu_torch.index.manifest import Manifest

DEFAULT_DIM = 128
FLOAT_STORAGE = ("float32", "bfloat16", "float16")


def _storage_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _normalize_rows(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return (x / np.maximum(norms, eps)).astype(np.float32)


def _ceil32(n: int) -> int:
    return (int(n) + 31) // 32 * 32


def pack_aligned(src: np.ndarray, lengths: np.ndarray, tail_pad_rows: int):
    """(flat [aligned_total + tail_pad_rows, dim] f32, offsets int64 [D]):
    each doc's rows normalized and placed at a 32-row-aligned offset, zeros
    elsewhere; the numpy fallback of ``visual_rag_tpu/native.py:114-162``."""
    dim = src.shape[1]
    aligned = (lengths.astype(np.int64) + 31) // 32 * 32
    flat = np.zeros((max(int(aligned.sum()), 1) + tail_pad_rows, dim), dtype=np.float32)
    offsets = np.zeros((len(lengths),), dtype=np.int64)
    if len(lengths):
        offsets[1:] = np.cumsum(aligned)[:-1]
    pos = 0
    for i, ln in enumerate(lengths.tolist()):
        if ln:
            block = src[pos : pos + ln]
            norms = np.linalg.norm(block, axis=1, keepdims=True)
            flat[offsets[i] : offsets[i] + ln] = block / np.maximum(norms, 1e-12)
        pos += ln
    return flat, offsets


def _to_storage(x: np.ndarray, storage_dtype: str, device) -> torch.Tensor:
    """Normalized f32 host rows -> a tensor of the storage dtype on ``device``."""
    if storage_dtype not in FLOAT_STORAGE:
        raise ValueError(f"build seals float stores {FLOAT_STORAGE}; make {storage_dtype!r} "
                         "from one with index/quantize.py::quantize_index")
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(getattr(torch, storage_dtype)).to(resolve_device(device))


@dataclasses.dataclass
class PaddedMultiVectors:
    """Dense padded multivector store: values [D, P, dim], mask [D, P] bool,
    and for int8 codes per-row f32 ``scales`` [D, P]."""

    values: torch.Tensor
    mask: torch.Tensor
    scales: Optional[torch.Tensor] = None
    kind: str = "multi"

    @property
    def num_docs(self) -> int:
        return int(self.values.shape[0])

    @property
    def dim(self) -> int:
        return int(self.values.shape[2])

    @property
    def storage_dtype(self) -> str:
        return _storage_name(self.values)

    def nbytes(self) -> int:
        return _nbytes(self.values) + self.mask.numel() + _nbytes(self.scales)

    def dequantized(self, compute_dtype=torch.float32) -> torch.Tensor:
        """Values in a matmul dtype (int8 rows rescaled)."""
        if self.scales is not None:
            return (self.values.float() * self.scales[..., None]).to(compute_dtype)
        return self.values.to(compute_dtype)

    @classmethod
    def build(cls, mats, storage_dtype: str = "bfloat16", max_rows: Optional[int] = None,
              dim: Optional[int] = None, device="cuda") -> "PaddedMultiVectors":
        """Stack host matrices [n_i, dim] into a padded store on ``device``,
        rows past ``max_rows`` cut."""
        mats = [np.asarray(m, dtype=np.float32) for m in mats]
        dim = mats[0].shape[1] if mats else (dim or DEFAULT_DIM)
        if max_rows is None:
            max_rows = max((m.shape[0] for m in mats), default=1)
        max_rows = max(1, int(max_rows))
        out = np.zeros((len(mats), max_rows, dim), dtype=np.float32)
        mask = np.zeros((len(mats), max_rows), dtype=bool)
        for i, m in enumerate(mats):
            t = min(m.shape[0], max_rows)
            if t:
                out[i, :t] = _normalize_rows(m[:t])
                mask[i, :t] = True
        return cls(values=_to_storage(out, storage_dtype, device),
                   mask=torch.from_numpy(mask).to(resolve_device(device)))


@dataclasses.dataclass
class RaggedMultiVectors:
    """Ragged token store: flat [N + pad, dim] plus per-doc offsets/lengths.

    ``offsets`` and ``lengths`` are int32 [D], as in the JAX store; callers
    that index with them convert to int64 themselves. int8 codes carry
    per-doc f32 ``scales`` [D]; ``int8_refined`` adds ``res4`` (uint8
    [N + pad, dim // 2], two int4 residual nibbles a byte) and ``res_scales``
    (f32 [N + pad], 0 on alignment rows).
    """

    flat: torch.Tensor
    offsets: torch.Tensor
    lengths: torch.Tensor
    max_len: int
    scales: Optional[torch.Tensor] = None
    res4: Optional[torch.Tensor] = None
    res_scales: Optional[torch.Tensor] = None
    kind: str = "multi_ragged"

    @property
    def num_docs(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def dim(self) -> int:
        return int(self.flat.shape[1])

    @property
    def storage_dtype(self) -> str:
        if self.res4 is not None:
            return "int8_refined"
        return _storage_name(self.flat)

    def nbytes(self) -> int:
        """Bytes of the store as the JAX store counts them (offsets and
        lengths 4 bytes each)."""
        return (_nbytes(self.flat) + self.offsets.numel() * 8 + _nbytes(self.scales)
                + _nbytes(self.res4) + _nbytes(self.res_scales))

    def dequantized_flat(self, refined: bool = True) -> torch.Tensor:
        """f32 flat token matrix with the per-doc int8 scales applied and,
        when present and ``refined``, the int4 residual added back (column
        2j in a byte's low nibble, 2j+1 in its high nibble: JAX
        ``store.py:223-239``)."""
        flat = self.flat.float()
        if self.scales is not None:  # rows outside every doc keep their codes, as in JAX
            doc = row_docs(self.offsets, self.lengths, flat.shape[0])
            flat = flat * torch.where(doc >= 0, self.scales.float()[doc.clamp(min=0)],
                                      1.0)[:, None]
        if refined and self.res4 is not None:
            flat = flat + unpack_int4(self.res4).float() * self.res_scales.float()[:, None]
        return flat

    @classmethod
    def build(cls, mats, storage_dtype: str = "bfloat16", dim: Optional[int] = None,
              device="cuda") -> "RaggedMultiVectors":
        """Pack host matrices [n_i, dim] into a ragged store on ``device``:
        32-row-aligned doc blocks and a tail pad of ``ceil32(max_len)``
        rows, as the JAX seal lays them out (``store.py:264-276``)."""
        mats = [np.asarray(m, dtype=np.float32) for m in mats]
        dim = mats[0].shape[1] if mats else (dim or DEFAULT_DIM)
        lengths = np.array([m.shape[0] for m in mats], dtype=np.int32)
        max_len = int(lengths.max()) if len(mats) else 1
        src = np.concatenate(mats, axis=0) if mats else np.zeros((0, dim), dtype=np.float32)
        flat, offsets = pack_aligned(src, lengths, tail_pad_rows=_ceil32(max_len))
        dev = resolve_device(device)
        return cls(flat=_to_storage(flat, storage_dtype, dev),
                   offsets=torch.from_numpy(offsets.astype(np.int32)).to(dev),
                   lengths=torch.from_numpy(lengths).to(dev), max_len=max_len)


def row_docs(offsets: torch.Tensor, lengths: torch.Tensor, n_rows: int) -> torch.Tensor:
    """int64 [n_rows]: the doc each row of a ragged store belongs to, -1 on
    alignment and tail-pad rows."""
    offs, lens = offsets.long(), lengths.long().clamp(min=0)
    dev = offs.device
    ids = torch.repeat_interleave(torch.arange(offs.shape[0], device=dev), lens)
    starts = torch.repeat_interleave(offs, lens)
    ranks = torch.arange(ids.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(lens, 0) - lens, lens)
    doc = torch.full((n_rows,), -1, dtype=torch.long, device=dev)
    doc[starts + ranks] = ids
    return doc


def unpack_int4(res4: torch.Tensor) -> torch.Tensor:
    """Residual codes int8 [..., 2 * n] in [-8, 7] from packed nibbles
    [..., n] (low nibble = even column, high = odd; code = nibble - 8)."""
    r = res4.to(torch.int16)
    lo, hi = (r & 15) - 8, (r >> 4) - 8
    return torch.stack((lo, hi), dim=-1).reshape(*res4.shape[:-1], -1).to(torch.int8)


@dataclasses.dataclass
class SingleVectors:
    """Dense single-vector store: values [D, dim], and for int8 codes
    per-row f32 ``scales`` [D]."""

    values: torch.Tensor
    scales: Optional[torch.Tensor] = None
    kind: str = "single"

    @property
    def num_docs(self) -> int:
        return int(self.values.shape[0])

    @property
    def dim(self) -> int:
        return int(self.values.shape[1])

    @property
    def storage_dtype(self) -> str:
        return _storage_name(self.values)

    def nbytes(self) -> int:
        return _nbytes(self.values) + _nbytes(self.scales)

    def dequantized(self, compute_dtype=torch.float32) -> torch.Tensor:
        if self.scales is not None:
            return (self.values.float() * self.scales[:, None]).to(compute_dtype)
        return self.values.to(compute_dtype)

    @classmethod
    def build(cls, vecs, storage_dtype: str = "bfloat16", dim: Optional[int] = None,
              device="cuda") -> "SingleVectors":
        """[D, dim] single vectors from host vectors, normalized, on ``device``."""
        if len(vecs) == 0:
            arr = np.zeros((0, dim or DEFAULT_DIM), dtype=np.float32)
        else:
            arr = np.asarray(vecs, dtype=np.float32)
        if arr.ndim != 2:
            arr = arr.reshape(len(vecs), -1)
        return cls(values=_to_storage(_normalize_rows(arr), storage_dtype, device))


@dataclasses.dataclass
class SealedIndex:
    """An immutable device-resident collection snapshot ready for queries."""

    stores: Dict[str, object]
    manifest: Manifest
    storage_dtype: str = "bfloat16"

    @property
    def num_docs(self) -> int:
        for s in self.stores.values():
            return s.num_docs
        return 0

    @property
    def vector_names(self):
        return sorted(self.stores.keys())

    @property
    def device(self) -> torch.device:
        st = next(iter(self.stores.values()))
        return (st.flat if isinstance(st, RaggedMultiVectors) else st.values).device

    def to(self, device) -> "SealedIndex":
        """A copy of the index with every tensor on ``device``."""
        stores = {
            name: dataclasses.replace(s, **{
                f.name: getattr(s, f.name).to(device) for f in dataclasses.fields(s)
                if isinstance(getattr(s, f.name), torch.Tensor)})
            for name, s in self.stores.items()}
        return SealedIndex(stores=stores, manifest=self.manifest,
                           storage_dtype=self.storage_dtype)

    def nbytes(self) -> int:
        return sum(s.nbytes() for s in self.stores.values())

    def store(self, name: str):
        if name not in self.stores:
            raise KeyError(
                f"Named vector {name!r} not in collection (have: {self.vector_names})")
        return self.stores[name]
