"""Tokenizers for query/prompt text.

A copy of ``visual_rag_tpu/models/tokenizer.py`` (numpy only), so that the
port needs nothing of the JAX package. The card path uses
:class:`HashTokenizer`; :class:`HFTokenizer` imports ``tokenizers`` when it
is built, and only from local files.

Two implementations behind one duck-typed interface (``encode``,
``batch_encode``, ``vocab``, ``pad_id``, ``special_mask``):

- :class:`HashTokenizer` — deterministic word-level hash tokenizer used when
  no real tokenizer files are available (air-gapped runs, synthetic tests).
  Ids live in [4, vocab) with 0-3 reserved, preserving the reference's
  special-token filter heuristic (visual_embedder.py:623 ``input_ids >= 4``).
- :class:`HFTokenizer` — a real HuggingFace ``tokenizers`` fast tokenizer
  loaded from LOCAL files only (a ``tokenizer.json`` file or a checkpoint
  directory containing one). Replaces the reference's
  ``AutoProcessor.from_pretrained`` tokenizer half (model_loader.py) for
  checkpoint-faithful inference; special tokens are filtered by their actual
  ids rather than the ``>= 4`` heuristic.

Select via ``VisualEmbedder(..., tokenizer_path=...)`` or the
``VISUALRAG_TOKENIZER`` env var.
"""

from __future__ import annotations

import hashlib
import logging
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


class HashTokenizer:
    """Deterministic word-level tokenizer: ids in [4, vocab) (0-3 reserved)."""

    def __init__(self, vocab: int = 49280, pad_id: int = 0, bos_id: int = 1):
        self.vocab = int(vocab)
        self.pad_id = pad_id
        self.bos_id = bos_id

    def encode(self, text: str) -> List[int]:
        ids = [self.bos_id]
        for word in text.lower().split():
            h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
            ids.append(4 + h % (self.vocab - 4))
        return ids

    def batch_encode(self, texts: Sequence[str], max_len: Optional[int] = None):
        encoded = [self.encode(t) for t in texts]
        max_len = max_len or max(len(e) for e in encoded)
        ids = np.full((len(texts), max_len), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), max_len), dtype=bool)
        for i, e in enumerate(encoded):
            e = e[:max_len]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = True
        return ids, mask

    def special_mask(self, ids: np.ndarray) -> np.ndarray:
        """True where the id is a special/reserved token (drop at pooling)."""
        return np.asarray(ids) < 4

    def token_to_id(self, token: str) -> Optional[int]:
        return None  # hash vocab has no named tokens


class HFTokenizer:
    """Real fast tokenizer loaded from local files (no network access).

    Accepts a path to a ``tokenizer.json`` or a directory containing one
    (an HF checkpoint snapshot). Mirrors the reference's processor text side
    (processing_colsmol / colqwen): encodes raw text; special tokens are
    identified by the tokenizer's own added-token table.
    """

    def __init__(self, path: str):
        from tokenizers import Tokenizer  # baked into the image

        p = Path(path)
        if p.is_dir():
            candidate = p / "tokenizer.json"
            if not candidate.exists():
                raise FileNotFoundError(f"no tokenizer.json under {p}")
            p = candidate
        elif not p.exists():
            raise FileNotFoundError(f"tokenizer file not found: {p}")
        try:
            self._tok = Tokenizer.from_file(str(p))
        except Exception as ex:  # tokenizers raises bare Exception on bad JSON
            raise ValueError(f"failed to parse tokenizer file {p}: {ex}") from ex
        self.vocab = int(self._tok.get_vocab_size(with_added_tokens=True))
        specials = set()
        try:
            for tid, added in self._tok.get_added_tokens_decoder().items():
                if getattr(added, "special", False):
                    specials.add(int(tid))
        except AttributeError:  # older tokenizers API
            pass
        # common special names, if present in the vocab
        for name in ("<pad>", "<s>", "</s>", "<unk>", "<bos>", "<eos>",
                     "<|endoftext|>", "<image>", "<fake_token_around_image>"):
            tid = self._tok.token_to_id(name)
            if tid is not None:
                specials.add(int(tid))
        self.special_ids = frozenset(specials)
        pad = self._tok.token_to_id("<pad>")
        self.pad_id = int(pad) if pad is not None else 0
        self._special_arr = np.asarray(sorted(self.special_ids), dtype=np.int64)
        logger.info("HFTokenizer loaded from %s (vocab=%d, %d special ids)",
                    p, self.vocab, len(self.special_ids))

    def encode(self, text: str) -> List[int]:
        return list(self._tok.encode(text).ids)

    def batch_encode(self, texts: Sequence[str], max_len: Optional[int] = None):
        encs = self._tok.encode_batch(list(texts))
        lists = [list(e.ids) for e in encs]
        max_len = max_len or max(len(e) for e in lists)
        ids = np.full((len(texts), max_len), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), max_len), dtype=bool)
        for i, e in enumerate(lists):
            e = e[:max_len]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = True
        return ids, mask

    def special_mask(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        if self._special_arr.size == 0:
            return np.zeros(ids.shape, dtype=bool)
        return np.isin(ids, self._special_arr)

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self._tok.token_to_id(token)
        return int(tid) if tid is not None else None


def load_tokenizer(path: Optional[str], vocab: int = 49280):
    """``path`` given -> HFTokenizer (local files); else the hash fallback."""
    if path:
        return HFTokenizer(path)
    return HashTokenizer(vocab=vocab)
