"""Kind ``search_batches``: a closed loop of query batches through
``RetrievalEngine.search_embedded_batches``, the throughput path.

The mix's parameters: the corpus (``lib/corpus.py::build_corpus``), the
queries (``query_tokens``, ``pool_batches`` distinct batches of ``batch``
cycled through the window), the search (``mode``, ``stage1_mode``,
``prefetch_k``, ``top_k``, ``depth``), ``sample`` answers checked, and the
``limits`` of the numbers compared.

End to end: ``search_qps``, every query answered over the window's
seconds; the window closes at the first batch finished at or after
``--seconds``, so it holds whole batches, and its clock ends in
``torch.cuda.synchronize()``. ``setup_s``: process start to the first
batch sent.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench_port.lib import common, corpus as corpus_lib
from bench_port.lib.trace import DeviceTrace


class RerankRecorder:
    """Keeps each rerank call's candidates and query mask (traced runs only)
    by wrapping the plans' ``local_rerank``: the readers need the distinct
    docs a batch reads."""

    def __init__(self):
        self.calls = []

    def install(self):
        from visual_rag_tpu_torch.retrieval import plans

        inner = plans.local_rerank

        def recorded(ragged, tokens, qmask, cand, impl, packed, b):
            self.calls.append((cand, qmask, impl))
            return inner(ragged, tokens, qmask, cand, impl, packed, b)

        plans.local_rerank = recorded
        return lambda: setattr(plans, "local_rerank", inner)


def batch_work(corp, calls):
    """Per batch, (rerank bytes, rerank ops, stage-1 bytes, stage-1 ops)."""
    from bench_port.lib.peaks import pooled_stage1_work, rerank_work

    lengths = corp.lengths_np
    dim, item = corp.flat.shape[1], corp.flat.element_size()
    valid_rows = int(corp.pooled_valid_np.sum())
    rows = corp.pooled.shape[0] * corp.pooled.shape[1]
    out = []
    for cand, qmask, _ in calls:
        c = cand.cpu().numpy()
        qrows = (qmask > 0).sum(1).cpu().numpy()
        live = c >= 0
        distinct = np.unique(c[live])
        pairs = zip(np.broadcast_to(qrows[:, None], c.shape)[live].tolist(),
                    lengths[c[live]].tolist())
        rb, ro = rerank_work(lengths[distinct], pairs, dim, item, c.shape[0],
                             qmask.shape[1], c.shape[1])
        sb, so = pooled_stage1_work(valid_rows, rows, corp.num_docs, dim, item, c.shape[0])
        out.append((rb, ro, sb, so))
    return out


def run(ctx: common.RunContext) -> common.Outcome:
    from visual_rag_tpu_torch.retrieval.engine import RetrievalEngine

    p, dev = ctx.params, ctx.device
    marks = common.Marks()
    corp = corpus_lib.build_corpus(p, ctx.seed, dev)
    engine = RetrievalEngine(corp.index)
    marks("corpus")
    bs, n_pool = int(p["batch"]), int(p["pool_batches"])
    pool = corpus_lib.make_queries(p, bs * n_pool, ctx.seed)
    marks("queries")
    batches = [pool[i * bs:(i + 1) * bs] for i in range(n_pool)]
    kw = dict(mode=p["mode"], stage1_mode=p["stage1_mode"], prefetch_k=int(p["prefetch_k"]),
              top_k=int(p["top_k"]), with_payload=False, return_arrays=True)
    for _ in engine.search_embedded_batches(batches[:2], depth=int(p["depth"]), **kw):
        pass  # warm: every shape the window sends
    marks("warm batches")
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    torch.cuda.reset_peak_memory_stats(dev) if dev.type == "cuda" else None

    recorder = RerankRecorder() if ctx.trace else None
    uninstall = recorder.install() if recorder else None
    sent = []  # pool index of each batch sent
    results = []
    tr = DeviceTrace(ctx.trace and dev.type == "cuda")

    def feed(deadline):
        i = 0
        while time.perf_counter() < deadline or i == 0:
            sent.append(i % n_pool)
            yield batches[i % n_pool]
            i += 1

    with tr:  # the profiler starts before the clock does
        setup_s = common.process_age_s()
        t0 = time.perf_counter()
        for res in engine.search_embedded_batches(feed(t0 + ctx.seconds),
                                                  depth=int(p["depth"]), **kw):
            results.append(res)
    window = time.perf_counter() - t0
    if uninstall:
        uninstall()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    answered = len(results) * bs

    # correct: a sample of the window's answers against the reference
    ref = ctx.cell.reference_module("search")
    pick = ref.sample_indices(answered, int(p["sample"]), ctx.seed)
    raw = [batches[sent[i // bs]][i % bs] for i in pick]
    got_ids = np.stack([corpus_lib.doc_ids(results[i // bs].ids[i % bs]) for i in pick])
    got_scores = np.stack([results[i // bs].scores[i % bs] for i in pick]).astype(np.float32)
    n_batches = len(results)
    facts = {"trace": tr, "window_s": window, "batches": n_batches}
    if recorder:
        facts["work"] = batch_work(corp, recorder.calls)
        facts["rerank_impls"] = sorted({impl for _, _, impl in recorder.calls})
    del engine, results, recorder
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_ids, ref_scores = ref.two_stage(corp, raw, int(p["prefetch_k"]), int(p["top_k"]))
    nums = ref.compare(corp, raw, got_ids, got_scores, ref_ids, ref_scores)
    lim = p["limits"]
    compared = {k: common.Limit(v, float(lim[k])) for k, v in nums.items()}
    return common.Outcome(
        attempted=answered, failed=0,
        end_to_end={"search_qps": answered / window, "setup_s": setup_s},
        compared=compared, memory_peak_bytes=int(peak), facts=facts,
        notes=[marks.note(), f"window {window:.3f} s, {n_batches} batches of {bs}, "
               f"{len(pick)} answers checked"])


def control(ctx: common.RunContext):
    """The control's readings at the cell's size: the bf16 reference in the
    program's place on a sample of the window's queries."""
    p = ctx.params
    corp = corpus_lib.build_corpus(p, ctx.seed, ctx.device)
    pool = corpus_lib.make_queries(p, int(p["batch"]) * int(p["pool_batches"]), ctx.seed)
    ref = ctx.cell.reference_module("search")
    raw = [pool[i] for i in ref.sample_indices(len(pool), int(p["sample"]), ctx.seed)]
    return ref.control_readings(corp, raw, int(p["prefetch_k"]), int(p["top_k"]))
