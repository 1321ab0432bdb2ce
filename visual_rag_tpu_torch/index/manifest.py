"""Host-side collection manifest: point ids and payloads.

Port of ``visual_rag_tpu/index/manifest.py:21-95`` (``ids``, ``payloads``,
``payload(i)``, ``__len__``). The JAX module itself imports no jax, but its
package ``__init__`` loads the JAX stores, so the port keeps its own copy.
Payload indexes and filters come with the filter port (ROADMAP A6).
"""

from __future__ import annotations

from typing import Any, Dict, List


class Manifest:
    """Ordered point registry: position in the device arrays == doc index."""

    def __init__(self, ids: List[str] = (), payloads: List[Dict[str, Any]] = ()):
        self.ids: List[str] = list(ids)
        self.payloads: List[Dict[str, Any]] = [dict(p) for p in payloads]
        if len(self.payloads) != len(self.ids):
            raise ValueError(
                f"{len(self.ids)} ids but {len(self.payloads)} payloads")

    def __len__(self) -> int:
        return len(self.ids)

    def payload(self, idx: int) -> Dict[str, Any]:
        return self.payloads[idx]
