"""Host-side collection manifest: point ids, payloads and payload indexes.

Port of ``visual_rag_tpu/index/manifest.py:21-117`` without persistence
(``save``/``load`` come with the persistence slice). The JAX module itself
imports no jax, but its package ``__init__`` loads the JAX stores, so the
port keeps its own copy.

Payload indexes are interned int32 columns: each indexed field gets a code
column and a value vocabulary, so a filter evaluates as one vectorised pass
per condition (``retrieval/filters.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np


class Manifest:
    """Ordered point registry: position in the device arrays == doc index."""

    MISSING_CODE = -1

    def __init__(self, ids: Iterable[str] = (), payloads: Iterable[Dict[str, Any]] = ()):
        self.ids: List[str] = []
        self.payloads: List[Dict[str, Any]] = []
        self._id_to_idx: Dict[str, int] = {}
        self._columns: Dict[str, np.ndarray] = {}  # field -> int32 codes
        self._vocabs: Dict[str, Dict[Any, int]] = {}  # field -> value -> code
        # bumped on every mutation: filter-mask caches key on (filter
        # signature, version), so appends invalidate stale masks
        self.version: int = 0
        ids, payloads = list(ids), list(payloads)
        if len(payloads) != len(ids):
            raise ValueError(f"{len(ids)} ids but {len(payloads)} payloads")
        for pid, pl in zip(ids, payloads):
            self.add(pid, pl)

    def __len__(self) -> int:
        return len(self.ids)

    def __contains__(self, point_id: str) -> bool:
        return point_id in self._id_to_idx

    def add(self, point_id: str, payload: Optional[Dict[str, Any]] = None) -> int:
        if point_id in self._id_to_idx:
            raise ValueError(f"Duplicate point id: {point_id}")
        idx = len(self.ids)
        self.ids.append(point_id)
        self.payloads.append(dict(payload or {}))
        self._id_to_idx[point_id] = idx
        self._columns.clear()  # indexes are rebuilt lazily after appends
        self.version += 1
        return idx

    def payload(self, idx: int) -> Dict[str, Any]:
        return self.payloads[idx]

    # -- payload indexes -------------------------------------------------------

    def create_payload_index(self, field: str) -> None:
        """Intern one payload field into an int32 code column."""
        vocab: Dict[Any, int] = {}
        codes = np.empty((len(self.ids),), dtype=np.int32)
        for i, pl in enumerate(self.payloads):
            v = pl.get(field)
            if v is None:
                codes[i] = self.MISSING_CODE
                continue
            codes[i] = vocab.setdefault(v, len(vocab))
        self._columns[field] = codes
        self._vocabs[field] = vocab

    def payload_index(self, field: str):
        """(codes, vocab) for an indexed field, building it on first use."""
        if field not in self._columns:
            self.create_payload_index(field)
        return self._columns[field], self._vocabs[field]

    def index_of(self, point_id: str) -> Optional[int]:
        return self._id_to_idx.get(point_id)

    def indices_of(self, point_ids: Iterable[str]) -> np.ndarray:
        out = [self._id_to_idx[p] for p in point_ids if p in self._id_to_idx]
        return np.asarray(out, dtype=np.int32)

    def id_mask(self, point_ids: Iterable[str]) -> np.ndarray:
        """Boolean doc mask from an id set (HasIdCondition equivalent)."""
        mask = np.zeros((len(self.ids),), dtype=bool)
        mask[self.indices_of(point_ids)] = True
        return mask
