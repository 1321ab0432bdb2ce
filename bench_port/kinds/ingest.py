"""Kind ``ingest``: pages of a PDF collection turned into index-ready
vectors through the program's ``VisualEmbedder.embed_images``,
``page_vectors`` and ``IndexBuilder.add``.

Page images (uint8 renders, ``page_sizes`` [height, width] each, a pool of
``pool_pages`` of each size drawn from the seed in set-up) go in calls of
``call_pages`` pages; the embedder cuts a call into batches of ``batch``
pages, and the sizes alternate batch by batch, so every batch holds pages
of one size. The seal is outside the window. Set-up checks the weight
table against the program's meta model, draws the weights on the card
straight into the serving dtypes (``lib/weights.py``; bf16 matrices and
tables, f32 norms: the model's bytes in those dtypes and one 256 MiB chunk
of f32 while it draws), and embeds one call to warm every shape. Its note
gives the model's parameters, their bytes in the serving dtypes and
set-up's peak bytes on the card, from which a new cell's set-up can be
reckoned.

End to end: ``ingest_pages_per_s``, the pages of every call in the window
over its seconds (the window closes at the first call that ends at or after
``--seconds``); ``setup_s``: process start to the window's first call.
After the window the program is freed and the plain reference embeds a
sample of the window's pages in f32 and pools them.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from bench_port.lib import common, model_work, weights
from bench_port.lib.trace import DeviceTrace

K10_KERNELS = ("flash_fwd_mma_kernel", "flash_fwd_kernel", "seg_tile_range")
VECTORS = ("initial", "mean_pooling", "experimental_pooling", "global_pooling")


def page_pool(p: Dict, seed: int) -> List[List[np.ndarray]]:
    """``pool_pages`` page images of each size, from the seed."""
    rng = np.random.default_rng([seed, 13])
    return [[rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(p["pool_pages"])]
            for h, w in p["page_sizes"]]


def call_pages(p: Dict, pool, call: int) -> List[np.ndarray]:
    """Call ``call``'s pages: ``call_pages // batch`` batches, each of one
    size, the sizes in turn."""
    bs, out = int(p["batch"]), []
    for j in range(int(p["call_pages"]) // bs):
        b = call * (int(p["call_pages"]) // bs) + j
        size = pool[b % len(pool)]
        start = (b // len(pool)) * bs
        out += [size[(start + k) % len(size)] for k in range(bs)]
    return out


def serving_state(table, pcfg, seed: int, dev) -> Dict[str, torch.Tensor]:
    """The program's weights in the dtypes its meta model holds them in,
    drawn once the table is known to fit the model."""
    from visual_rag_tpu_torch.models.colvlm import ColVLM

    meta = ColVLM(pcfg, device="meta").state_dict()
    weights.check_names(table, meta)
    return weights.draw(table, seed, dev, {k: v.dtype for k, v in meta.items()})


def run(ctx: common.RunContext) -> common.Outcome:
    from visual_rag_tpu_torch.index.builder import CollectionSchema, IndexBuilder
    from visual_rag_tpu_torch.models.embedder import VisualEmbedder
    from visual_rag_tpu_torch.pipeline.vectors import experimental_vector_plan, page_vectors

    cfg, p, dev = ctx.cell.config, ctx.params, ctx.device
    arch = ctx.cell.arch
    marks = common.Marks()
    pcfg = arch.program_config(cfg)
    params = serving_state(arch.leaves(cfg), pcfg, ctx.seed, dev)
    model_note = (f"model {sum(v.numel() for v in params.values())} parameters, "
                  f"{sum(v.numel() * v.element_size() for v in params.values())} bytes "
                  "in its serving dtypes")
    embedder = VisualEmbedder(p["model_name"], batch_size=int(p["batch"]), config=pcfg,
                              params=params, device=dev)
    del params  # the embedder holds them, and frees them with itself
    builder = IndexBuilder(CollectionSchema.standard(
        experimental_names=experimental_vector_plan(embedder.backend)["names"]))
    pool = page_pool(p, ctx.seed)
    marks("weights and pages")

    def ingest(call: int, keep: list) -> int:
        pages = call_pages(p, pool, call)
        embs, infos = embedder.embed_images(pages, return_token_info=True)
        for k, (emb, info) in enumerate(zip(embs, infos)):
            vectors, payload = page_vectors(embedder, emb, info)
            builder.add(f"c{call}p{k}", vectors, payload)
            keep.append((call, k, vectors))
        return len(pages)

    ingest(-1, [])  # warm: every size the window sends
    marks("warm call")
    setup_peak = "not measured (no card)"
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        setup_peak = f"{torch.cuda.max_memory_allocated(dev)} bytes"
        torch.cuda.reset_peak_memory_stats(dev)
    tr = DeviceTrace(ctx.trace and dev.type == "cuda")
    kept: list = []
    calls = pages = 0
    with tr:  # the profiler starts before the clock does
        setup_s = common.process_age_s()
        t0 = time.perf_counter()
        while calls == 0 or time.perf_counter() - t0 < ctx.seconds:
            pages += ingest(calls, kept)
            calls += 1
    window = tr.window_s
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    ref = ctx.cell.reference_module()
    facts: Dict = {"trace": tr, "window_s": window, "calls": calls}
    if ctx.trace:
        bs, n_prompt = int(p["batch"]), len(ref.prompt_ids(pcfg.text.vocab))
        forwards = []
        for c in range(calls):
            for b in range(int(p["call_pages"]) // bs):
                lay = []
                for img in call_pages(p, pool, c)[b * bs:(b + 1) * bs]:
                    pg = ref.process_page(img, cfg)
                    pg["n_prompt"] = n_prompt
                    lay.append(model_work.page_layout(pg))
                forwards.append((lay, []))
        facts.update(config=cfg, arch=arch, forwards=forwards, attention_kernels=K10_KERNELS,
                     **model_work.window_work(arch, cfg, forwards, 1, False))
    pick = ref_sample(len(kept), int(p["sample"]), ctx.seed)
    chosen = [kept[i] for i in pick]
    del embedder, builder
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    nums = compare_pages(ctx, pool, chosen)
    lim = p["limits"]
    return common.Outcome(
        attempted=pages, failed=0,
        end_to_end={"ingest_pages_per_s": pages / window, "setup_s": setup_s},
        compared={k: common.Limit(v, float(lim[k])) for k, v in nums.items()},
        memory_peak_bytes=int(peak), facts=facts,
        notes=[marks.note(), f"{model_note}; set-up peak {setup_peak}",
               f"window {window:.3f} s, {calls} calls, {pages} pages, "
               f"{len(chosen)} pages checked"])


def ref_sample(n: int, k: int, seed: int) -> List[int]:
    rng = np.random.default_rng([seed, 17])
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def compare_pages(ctx: common.RunContext, pool, chosen) -> Dict[str, float]:
    """The numbers compared: the largest L2 distance between a row the
    program stored and the reference's, over the image tokens' rows
    (``token_gap``) and over the pooled rows (``pooled_gap``), of the
    sampled pages."""
    cfg, p, dev = ctx.cell.config, ctx.params, ctx.device
    ref = ctx.cell.reference_module()
    params = weights.draw(ctx.cell.arch.leaves(cfg), ctx.seed, dev)
    model = ref.Reference(cfg, params)
    token_gap = pooled_gap = 0.0
    with ref.exact_f32(), torch.no_grad():
        for call, k, got in chosen:
            pg = ref.process_page(call_pages(p, pool, call)[k], cfg)
            want = ref.page_vectors(model.page(pg, dev), pg)
            for name in VECTORS:
                a = np.asarray(got[name], np.float64)
                if a.size != want[name].size:  # another page's vectors
                    d = float("inf")
                else:
                    d = float(np.max(np.linalg.norm(a.reshape(want[name].shape) - want[name],
                                                    axis=-1)))
                if name == "initial":
                    token_gap = max(token_gap, d)
                else:
                    pooled_gap = max(pooled_gap, d)
    return {"token_gap": token_gap, "pooled_gap": pooled_gap}


def control(ctx: common.RunContext) -> Dict[str, float]:
    """The control: the reference in fp8 in the program's place on pages of
    the cell's pool, against the reference in f32."""
    cfg, p, dev = ctx.cell.config, ctx.params, ctx.device
    ref = ctx.cell.reference_module()
    pool = page_pool(p, ctx.seed)
    params = weights.draw(ctx.cell.arch.leaves(cfg), ctx.seed, dev)
    f32, fp8 = ref.Reference(cfg, params), ref.Reference(cfg, params, precision="fp8")
    token_gap = pooled_gap = 0.0
    with ref.exact_f32(), torch.no_grad():
        for call in range(int(p["sample"]) // 2):
            for k in (0, int(p["batch"])):
                pg = ref.process_page(call_pages(p, pool, call)[k], cfg)
                got = ref.page_vectors(fp8.page(pg, dev), pg)
                want = ref.page_vectors(f32.page(pg, dev), pg)
                for name in VECTORS:
                    d = float(np.max(np.linalg.norm(got[name] - want[name], axis=-1)))
                    if name == "initial":
                        token_gap = max(token_gap, d)
                    else:
                        pooled_gap = max(pooled_gap, d)
    return {"token_gap": token_gap, "pooled_gap": pooled_gap}
