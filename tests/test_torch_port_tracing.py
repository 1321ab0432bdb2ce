"""The port's spans (``visual_rag_tpu_torch/tracing.py``) on the CPU.

Recording is on exactly while a ``torch.profiler`` session is active: off,
a span records nothing; on, spans close in order with their counts, lie on
the profiler's clock (a span around a torch op contains the op's kineto
interval), and the buffer drops what passes its bound. Then the names and
counts each layer records: the processor and the patches' copy in the
embedder, the model's vision tower and decoder, the engine's dispatch and finish around the plans' stage-1, the
trainer's step and optimizer. The CUDA case (``device_ms``) is in
``test_torch_port_cuda.py``.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from visual_rag_tpu_torch import synthetic_index, tracing
from visual_rag_tpu_torch.models.colvlm import ColVLMConfig
from visual_rag_tpu_torch.models.embedder import VisualEmbedder
from visual_rag_tpu_torch.models.train import Trainer, synthetic_batch
from visual_rag_tpu_torch.retrieval import plans
from visual_rag_tpu_torch.retrieval.engine import RetrievalEngine
from visual_rag_tpu_torch.tracing import span

torch.set_num_threads(1)  # tier-1 runs several test workers at once


@contextlib.contextmanager
def recording():
    """A CPU profiler session over a cleared span buffer."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof


def _named(records, name):
    return [s for s in records if s.name == name]


def _inside(inner, outer):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_off_records_nothing():
    tracing.clear()
    with span("a", pages=3):
        with span("b", device=torch.device("cpu")):
            pass
    assert span("c") is span("d")  # one shared no-op, nothing made per span
    assert tracing.spans() == [] and tracing.BUFFER.dropped == 0


def test_on_records_names_counts_and_times_in_closing_order():
    with recording():
        with span("outer", pages=2):
            with span("inner", device=torch.device("cpu")):
                pass
        with span("after"):
            pass
    recs = tracing.spans()
    assert [s.name for s in recs] == ["inner", "outer", "after"]
    inner, outer, after = recs
    assert outer.counts == {"pages": 2} and inner.counts == {} and after.counts == {}
    assert all(s.device_ms is None for s in recs)  # no CUDA device given
    assert _inside(inner, outer) and outer.end_ns <= after.start_ns <= after.end_ns


def test_spans_share_the_profilers_clock():
    a = torch.randn(256, 256)
    with recording() as prof:
        with span("matmul"):
            torch.mm(a, a)
    (sp,) = tracing.spans()
    ops = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "aten::mm"]
    assert len(ops) == 1
    start, end = ops[0].start_ns(), ops[0].start_ns() + ops[0].duration_ns()
    assert sp.start_ns <= start < end <= sp.end_ns


def test_buffer_keeps_its_bound_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(tracing.BUFFER, "limit", 3)
    with recording():
        for i in range(5):
            with span("s", i=i):
                pass
    assert [s.counts["i"] for s in tracing.spans()] == [0, 1, 2]
    assert tracing.BUFFER.dropped == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.BUFFER.dropped == 0


def _embedder(batch_size):
    tiny = ColVLMConfig.tiny()
    cfg = dataclasses.replace(
        tiny, dtype="float32",
        vision=dataclasses.replace(tiny.vision, pixel_shuffle=2, max_patches=2048))
    return VisualEmbedder("vidore/colSmol-500M", config=cfg, batch_size=batch_size, seed=0,
                          device="cpu")


def test_embed_batches_record_processor_and_copy():
    emb = _embedder(batch_size=2)
    rng = np.random.default_rng(0)
    pages = [rng.integers(0, 256, (int(rng.integers(150, 400)), 300, 3), dtype=np.uint8)
             for _ in range(3)]
    emb.embed_images(pages[:1])  # the model is built outside the recording
    with recording():
        emb.embed_images(pages)
    recs = tracing.spans()
    assert [s.name for s in recs] == ["processor.images", "embed.to_device", "vision.tower",
                                      "text.decoder"] * 2
    proc, copy = _named(recs, "processor.images"), _named(recs, "embed.to_device")
    assert [s.counts for s in proc] == [{"pages": 2}, {"pages": 1}]
    assert [s.counts for s in copy] == [{"pages": 2}, {"pages": 1}]
    for p, c in zip(proc, copy):
        assert p.end_ns <= c.start_ns and c.device_ms is None
    for tower, decoder in zip(_named(recs, "vision.tower"), _named(recs, "text.decoder")):
        assert tower.end_ns <= decoder.start_ns  # the tower's output goes into the decoder
        assert tower.counts["patches"] > 0 and decoder.counts["tokens"] > 0


def _engine_and_batches():
    index = synthetic_index(96, dim=32, min_tokens=8, max_tokens=40, pooled_rows=4,
                            storage_dtype="float32", seed=1, device="cpu")
    rng = np.random.default_rng(2)
    batches = [[rng.standard_normal((int(rng.integers(3, 12)), 32)).astype(np.float32)
                for _ in range(n)] for n in (5, 3)]
    return RetrievalEngine(index), batches


SEARCHES = {
    "single_full": dict(mode="single_full", top_k=5),
    "two_stage": dict(mode="two_stage", prefetch_k=20, top_k=5),
    "three_stage": dict(mode="three_stage", stage1_k=40, stage2_k=20, top_k=5),
}


@pytest.mark.parametrize("mode", sorted(SEARCHES))
def test_search_dispatch_holds_the_stage1_and_finish_follows(mode):
    kw = SEARCHES[mode]
    engine, batches = _engine_and_batches()
    want = list(engine.search_embedded_batches(batches, depth=1, **kw))
    with recording():
        got = list(engine.search_embedded_batches(batches, depth=1, **kw))
    assert got == want
    recs = tracing.spans()
    # depth 1: batch 0 dispatched, batch 1 dispatched, batch 0 finished, ...
    assert [s.name for s in recs] == ["search.stage1", "search.dispatch"] * 2 + [
        "search.finish"] * 2
    (s0, s1), (d0, d1) = _named(recs, "search.stage1"), _named(recs, "search.dispatch")
    f0, f1 = _named(recs, "search.finish")
    assert _inside(s0, d0) and _inside(s1, d1)
    assert d1.end_ns <= f0.start_ns and f0.end_ns <= f1.start_ns
    assert all(s.counts == {} for s in recs)
    assert s0.device_ms is None  # the index lives on the CPU


def test_a_swapped_local_rerank_still_sees_every_call(monkeypatch):
    engine, batches = _engine_and_batches()
    inner, calls = plans.local_rerank, []

    def recorded(*args):
        calls.append(args[3].shape)
        return inner(*args)

    monkeypatch.setattr(plans, "local_rerank", recorded)
    kw = SEARCHES["two_stage"]
    with recording():
        list(engine.search_embedded_batches(batches, depth=2, **kw))
    list(engine.search_embedded_batches(batches, depth=2, **kw))
    assert calls == [(8, 20), (4, 20)] * 2  # batches bucketed to 8 and 4 queries
    assert len(_named(tracing.spans(), "search.stage1")) == 2


def test_train_step_spans():
    cfg = ColVLMConfig.tiny()
    trainer = Trainer(cfg, lr=1e-4, warmup=0, device="cpu")
    state = trainer.init_state(seed=0)
    step = trainer.make_train_step()
    batch = synthetic_batch(cfg, batch=2, query_len=6, n_patches=64, seed=1)
    step(state.params, state.opt_state, batch)
    with recording():
        step(state.params, state.opt_state, batch)
    recs = tracing.spans()
    # the queries' decoder, then the pages' tower and decoder, then the update
    assert [s.name for s in recs] == ["text.decoder", "vision.tower", "text.decoder",
                                      "train.optimizer", "train.step"]
    assert [s.counts for s in recs[:3]] == [{"tokens": 12}, {"patches": 128}, {"tokens": 136}]
    opt, root = recs[-2:]
    assert _inside(opt, root) and opt.end_ns - opt.start_ns < root.end_ns - root.start_ns
    assert opt.counts == {} and root.counts == {}
