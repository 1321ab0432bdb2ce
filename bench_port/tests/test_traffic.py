"""Every traffic generator is deterministic per seed, and gives every seed
the same sizes (only their order and values change)."""

from __future__ import annotations

import numpy as np

from bench_port.lib import corpus
from bench_port.lib.common import BENCH_DIR, load_module
from bench_port.tests import tiny

SEEDS = (tiny.SEED, tiny.SEED + 1)


def _kind(name):
    return load_module(BENCH_DIR / "kinds" / f"{name}.py")


def test_corpus_is_deterministic_and_its_sizes_fixed():
    p = tiny.cell("colqwen25.search.b1024").traffic
    a, b = (corpus.build_corpus(p, SEEDS[0], tiny.CPU) for _ in range(2))
    c = corpus.build_corpus(p, SEEDS[1], tiny.CPU)
    assert np.array_equal(a.lengths_np, b.lengths_np)
    assert a.flat.equal(b.flat) and a.pooled.equal(b.pooled)
    assert not np.array_equal(a.lengths_np, c.lengths_np)
    assert sorted(a.lengths_np) == sorted(c.lengths_np)  # the same rows, another order
    assert a.flat.shape == c.flat.shape and not a.flat.equal(c.flat)
    lo, hi = p["tokens"]
    assert a.lengths_np.min() >= lo and a.lengths_np.max() <= hi
    assert (a.pooled_mask.sum(1).numpy() == a.pooled_valid_np).all()


def test_queries_are_deterministic():
    p = tiny.cell("colqwen25.search.b1024").traffic
    a, b, c = (corpus.make_queries(p, 50, s) for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert sorted(q.shape[0] for q in a) == sorted(q.shape[0] for q in c)
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_training_batches_are_deterministic_and_all_differ():
    train = _kind("train")
    p = tiny.cell("colqwen25.train.b4").traffic
    a, b = train.raw_batch(p, 1000, SEEDS[0], 0), train.raw_batch(p, 1000, SEEDS[0], 0)
    c = train.raw_batch(p, 1000, SEEDS[0], 1)
    assert all(np.array_equal(x, y) for x, y in zip(a["pages"], b["pages"]))
    assert all(np.array_equal(x, y) for x, y in zip(a["queries"], b["queries"]))
    assert not np.array_equal(a["pages"][0], c["pages"][0])
    assert sorted(map(len, a["queries"])) == sorted(map(len, c["queries"]))


def test_ingest_pages_are_deterministic_and_alternate_sizes():
    ingest = _kind("ingest")
    p = tiny.cell("colsmol.ingest.b8").traffic
    a, b = ingest.page_pool(p, SEEDS[0]), ingest.page_pool(p, SEEDS[0])
    assert all(np.array_equal(x, y) for s, t in zip(a, b) for x, y in zip(s, t))
    pages = ingest.call_pages(p, a, 0)
    bs = p["batch"]
    sizes = [pg.shape[:2] for pg in pages]
    assert sizes[:bs] == [tuple(p["page_sizes"][0])] * bs
    assert sizes[bs:2 * bs] == [tuple(p["page_sizes"][1])] * bs
