"""visual_rag_tpu_torch — the PyTorch/CUDA port of :mod:`visual_rag_tpu`.

The JAX package stays beside it as the reference. This package mirrors its
layout (``models``, ``index``, ``pipeline``, ``retrieval``, ``ops/kernels``,
``serving``) so that each module's counterpart is easy to find, imports
``torch`` and never ``jax``, and runs every kernel of its embedding and
query paths as a hand-written CUDA kernel for Hopper (``csrc/``). On CPU
tensors the kernels' plain PyTorch versions run instead, which is how the
tests hold the port against the JAX package.

Counterpart of ``visual_rag_tpu/__init__.py:51-73``: heavy modules load
lazily through module ``__getattr__``.
"""

from __future__ import annotations

_LAZY_ATTRS = {
    "CollectionSchema": "visual_rag_tpu_torch.index.builder",
    "IndexBuilder": "visual_rag_tpu_torch.index.builder",
    "VisualEmbedder": "visual_rag_tpu_torch.models.embedder",
    "PayloadFilter": "visual_rag_tpu_torch.retrieval.filters",
    "RetrievalEngine": "visual_rag_tpu_torch.retrieval.engine",
    "SealedIndex": "visual_rag_tpu_torch.index.store",
    "build_filter": "visual_rag_tpu_torch.retrieval.filters",
    "synthetic_index": "visual_rag_tpu_torch.index.synth",
}


def __getattr__(name: str):
    target = _LAZY_ATTRS.get(name)
    if target is None:
        raise AttributeError(
            f"module 'visual_rag_tpu_torch' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(target), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(list(globals().keys()) + list(_LAZY_ATTRS.keys()))
