"""Payload filtering: host-evaluated conditions -> a boolean doc mask.

Port of ``visual_rag_tpu/retrieval/filters.py:22-111``. Every condition
compiles to a boolean mask over the manifest's interned payload columns
(``index/manifest.py``), the conditions are ANDed, and the engine moves the
mask to the device once per distinct filter. The JAX module evaluates
through ``visual_rag_tpu.native``; here the same equality and membership
tests are numpy, so that a program on the card imports nothing of the JAX
package. The engine accepts the JAX package's ``PayloadFilter`` too (same
``is_empty``/``signature``/``evaluate`` surface).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Scalar = Union[str, int, float, bool]
_LISTS = (list, tuple, set, frozenset)


@dataclasses.dataclass
class PayloadFilter:
    """Conjunction of field conditions; each value may be a scalar or a list
    (MatchAny); ``ids`` restricts to a point-id set (HasIdCondition)."""

    must: List[Tuple[str, Union[Scalar, Sequence[Scalar]]]] = dataclasses.field(
        default_factory=list)
    ids: Optional[Sequence[str]] = None

    def is_empty(self) -> bool:
        return not self.must and self.ids is None

    def signature(self) -> Tuple:
        """Hashable identity for the engine's mask memo. List values and id
        sets are order-insensitive, so the signature sorts them."""
        must_sig = tuple(
            (field, tuple(sorted(map(repr, value))) if isinstance(value, _LISTS) else value)
            for field, value in self.must)
        ids_sig = None if self.ids is None else (len(self.ids), hash(frozenset(self.ids)))
        return (must_sig, ids_sig)

    def evaluate(self, manifest) -> np.ndarray:
        """Boolean mask [num_docs] over the manifest."""
        n = len(manifest)
        mask = np.ones((n,), dtype=bool)
        for field, value in self.must:
            codes, vocab = manifest.payload_index(field)
            if isinstance(value, _LISTS):
                wanted = [vocab[v] for v in value if v in vocab]
                if not wanted:
                    return np.zeros((n,), dtype=bool)
                mask &= np.isin(codes, wanted)
            else:
                code = vocab.get(value)
                if code is None:
                    return np.zeros((n,), dtype=bool)
                mask &= codes == code
        if self.ids is not None:
            mask &= manifest.id_mask(self.ids)
        return mask


def build_filter(
    year: Optional[Union[int, Sequence[int]]] = None,
    source: Optional[Union[str, Sequence[str]]] = None,
    district: Optional[Union[str, Sequence[str]]] = None,
    filename: Optional[Union[str, Sequence[str]]] = None,
    has_text: Optional[bool] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Optional[PayloadFilter]:
    """Filter over the reference's payload fields; None when no condition is
    given (the reference passes ``filter_obj=None`` through)."""
    must: List[Tuple[str, Any]] = [
        (field, value) for field, value in (
            ("year", year), ("source", source), ("district", district),
            ("filename", filename), ("has_text", has_text))
        if value is not None]
    must += [(field, value) for field, value in (extra or {}).items() if value is not None]
    return PayloadFilter(must=must) if must else None
