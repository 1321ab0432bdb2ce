"""Kind ``train``: contrastive fine-tuning through the program's ``Trainer``
and the step function of ``make_train_step()``, as a job runs it.

Each step takes ``pairs`` (query, page) pairs drawn from the seed: page
images (uint8, ``page_px`` [height, width]) that the program's processor
turns into patches inside the loop, as a job's input pipeline does, and
queries of ``query_tokens`` [lo, hi] token ids. Set-up draws the weights
on the card (``lib/weights.py``), builds the trainer around them and takes
the first ``check_steps`` steps through the same step function on batches
that all differ; it records each step's loss with the embeddings the loss
took, each leaf's gradient as the optimizer took it (its first moment
after step 1 over 1 - b1) and each leaf's change after the last of them.
It then draws ``pool_steps`` further batches, and the window runs steps
through them in turn until the first that ends at or after ``--seconds``,
so the window's host time is the processor's and the step's, not the
draw's.

End to end: ``train_pairs_per_s``, the pairs of every step in the window
over its seconds; ``setup_s``: process start to the window's first step.
After the window the program's state is freed and the plain reference
(``reference/colvlm.py``) follows the same first steps in f32.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import json

import numpy as np
import torch

from bench_port.lib import common, model_work, weights
from bench_port.lib.corpus import spread
from bench_port.lib.trace import DeviceTrace

ATTENTION_KERNELS = ("flash_fwd_lse", "flash_bwd_", "seg_tile_range")


def raw_batch(p: Dict, vocab: int, seed: int, step: int) -> Dict:
    """Step ``step``'s pages (uint8 images) and queries (token ids, a 1
    first), from the seed."""
    rng = np.random.default_rng([seed, 11, step])
    h, w = p["page_px"]
    pages = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(p["pairs"])]
    lens = spread(*p["query_tokens"], p["pairs"], rng)
    queries = [np.concatenate([[1], rng.integers(4, vocab, int(n) - 1)]).astype(np.int64)
               for n in lens]
    return {"pages": pages, "queries": queries}


def program_batch(processor, raw: Dict) -> Dict:
    """The trainer's batch: pages through the program's processor, queries
    padded."""
    proc = processor.process_images(raw["pages"])
    qlen = max(len(q) for q in raw["queries"])
    ids = np.zeros((len(raw["queries"]), qlen), np.int32)
    mask = np.zeros(ids.shape, bool)
    for i, q in enumerate(raw["queries"]):
        ids[i, :len(q)], mask[i, :len(q)] = q, True
    batch = {"query_ids": ids, "query_mask": mask, "page_ids": proc.input_ids,
             "page_mask": proc.attn_mask, "patches": proc.patches,
             "patch_mask": proc.patch_mask}
    if proc.window_ids is not None:
        batch["window_ids"] = proc.window_ids
    return batch


def processor_for(backend: str, pcfg):
    """The program's image processor as its embedder builds it."""
    from visual_rag_tpu_torch.models.processors import ImageProcessor

    ratio = max(pcfg.spatial_merge ** 2, pcfg.vision.pixel_shuffle ** 2, 1)
    return ImageProcessor(backend=backend, image_token_id=pcfg.image_token_id,
                          patch_pixels=pcfg.vision.patch_pixels, vocab=pcfg.text.vocab,
                          max_visual_tokens=pcfg.vision.max_patches // ratio,
                          pixel_shuffle=pcfg.vision.pixel_shuffle)


def window_pool(p: Dict, vocab: int, seed: int, start: int) -> List[Dict]:
    """The ``pool_steps`` batches the window runs through in turn: the steps
    after the checked ones, drawn in set-up."""
    return [raw_batch(p, vocab, seed, start + i) for i in range(int(p["pool_steps"]))]


def _rows(embs, masks) -> List[np.ndarray]:
    return [e[m.bool()].detach().double().cpu().numpy() for e, m in zip(embs, masks)]


@contextlib.contextmanager
def recorded_loss_inputs(got: Dict, plant_half: bool = False):
    """Keep what the program's loss reduces over at each step, the valid
    embedding rows of each query and of each page as the loss takes them,
    in ``got["loss_inputs"]``, by wrapping the trainer module's loss
    function. With ``plant_half`` also keep, in ``got["half_loss"]``, the
    loss the step would return if the loss took the mean over the first half
    of the pairs only: the fault's reading (the step itself stays sound)."""
    from visual_rag_tpu_torch.models import train as train_mod

    inner = train_mod.colbert_infonce_loss

    def loss(q_emb, q_mask, p_emb, p_mask, **kw):
        got.setdefault("loss_inputs", []).append((_rows(q_emb, q_mask), _rows(p_emb, p_mask)))
        if plant_half:
            h = max(1, len(q_emb) // 2)
            with torch.no_grad():
                half = inner(q_emb[:h], q_mask[:h], p_emb[:h], p_mask[:h], **kw)[0]
            got.setdefault("half_loss", []).append(float(half))
        return inner(q_emb, q_mask, p_emb, p_mask, **kw)

    train_mod.colbert_infonce_loss = loss
    try:
        yield
    finally:
        train_mod.colbert_infonce_loss = inner


def reference_batch(ref, cfg: Dict, vocab: int, raw: Dict) -> Dict:
    pages = []
    for img in raw["pages"]:
        pg = ref.process_page(img, cfg)
        pg["n_prompt"] = len(ref.prompt_ids(vocab))
        pages.append(pg)
    return {"pages": pages, "queries": raw["queries"]}


def loss_gaps(ref, losses: List[float], loss_inputs: List, temperature: float) -> List[float]:
    """Each step's |loss - the reference's loss over the embeddings that
    step's loss took| (f64, on the host)."""
    out = []
    for loss, (qs, ps) in zip(losses, loss_inputs):
        want = ref.infonce([torch.from_numpy(q) for q in qs], [torch.from_numpy(x) for x in ps],
                           temperature)
        out.append(abs(loss - float(want)))
    return out


def compare(ref, got: Dict, want: Dict, temperature: float):
    """The numbers compared for ``correct``, and what is reported beside them.

    ``embed_gap``: the largest L2 distance between a row of step 1's
    embeddings (every query and page of the batch, as the loss takes them)
    and the reference's. ``loss_gap``: the largest over the checked steps of
    |the loss the step returned - the reference's loss over the embeddings
    that step's loss took|, so a loss that reduces over other pairs than the
    batch's shows. ``step_gap`` (where ``want`` has the change): each leaf's
    change after the checked steps, by the worst leaf's |norm - the
    reference's| over the larger of the reference's norm and the median
    leaf's; leaves whose reference gradient is zero but for rounding are
    left out (``rounding_leaves``).

    Reported beside them, not compared (PERF.md, §4: the fp8 control reads
    no higher on it than sound runs): ``grad_gap``, step 1's gradient as the
    optimizer took it, by the median leaf, measured as ``step_gap``; and
    its worst leaf."""
    skip = ref.rounding_leaves(want["grad_norms"])
    grads = ref.leaf_gaps(got["grad_norms"], want["grad_norms"], skip)
    qs, ps = got["loss_inputs"][0]
    nums = {"embed_gap": ref.embedding_gap(qs + ps, want["embeddings"]),
            "loss_gap": max(loss_gaps(ref, got["loss"], got["loss_inputs"], temperature))}
    worst = max(grads, key=grads.get)
    med = float(np.median(list(want["grad_norms"].values())))
    reported = {"grad_gap": float(np.median(list(grads.values()))),
                "worst_gradient_leaf": worst, "worst_gradient_gap": grads[worst],
                "its_norm_over_median": want["grad_norms"][worst] / med,
                "rounding_leaves": len(skip)}
    if "delta_norms" in want:
        steps = ref.leaf_gaps(got["delta_norms"], want["delta_norms"], skip)
        nums["step_gap"] = max(steps.values())
        reported["worst_change_leaf"] = max(steps, key=steps.get)
    return nums, reported


def reference_readings(ctx: common.RunContext) -> Dict:
    """The reference's losses, step-1 embeddings and gradient norms, and
    change norms over the first ``check_steps`` batches, from the seed
    alone."""
    cfg, p, dev = ctx.cell.config, ctx.params, ctx.device
    arch, ref = ctx.cell.arch, ctx.cell.reference_module()
    table, vocab = arch.leaves(cfg), arch.vocab(cfg)
    params = weights.draw(table, ctx.seed, dev)
    batches = [reference_batch(ref, cfg, vocab, raw_batch(p, vocab, ctx.seed, i))
               for i in range(int(p["check_steps"]))]
    out = ref.train_steps(cfg, params, batches, float(p["lr"]), float(p["temperature"]))
    out["delta_norms"] = weights.initial_norms_of_change(table, ctx.seed, params)
    return out


def checked_steps(ctx: common.RunContext, plant_half: bool = False):
    """Set-up up to the window: the weights drawn, the trainer built around
    them, and the first ``check_steps`` steps through the window's own step
    function, with what :func:`compare` reads of them."""
    from visual_rag_tpu_torch.models.train import Trainer

    cfg, p, dev = ctx.cell.config, ctx.params, ctx.device
    arch = ctx.cell.arch
    table = arch.leaves(cfg)
    marks = common.Marks()
    pcfg = arch.program_config(cfg, remat=bool(p["remat"]))
    trainer = Trainer(pcfg, lr=float(p["lr"]), temperature=float(p["temperature"]),
                      warmup=0, device=dev)
    weights.check_names(table, trainer.model.state_dict())
    params = weights.draw(table, ctx.seed, dev)
    state = trainer.init_state(params=params)
    del params
    marks("weights and optimizer state")
    step_fn = trainer.make_train_step()
    processor = processor_for(arch.BACKEND, pcfg)
    got: Dict = {"loss": [], "marks": marks}
    n_check = int(p["check_steps"])
    with recorded_loss_inputs(got, plant_half):
        for i in range(n_check):
            batch = program_batch(processor, raw_batch(p, pcfg.text.vocab, ctx.seed, i))
            metrics = step_fn(state.params, state.opt_state, batch)[2]
            got["loss"].append(float(metrics["loss"]))
            if i == 0:  # the optimizer's first moment is (1 - b1) x the gradient it took
                b1 = trainer.optimizer.b1
                got["grad_norms"] = {k: float(torch.linalg.vector_norm(m.double())) / (1 - b1)
                                     for k, m in state.opt_state.mu.items()}
    marks(f"{n_check} checked steps")
    got["delta_norms"] = weights.initial_norms_of_change(table, ctx.seed, state.params)
    marks("change norms")
    return trainer, state, step_fn, processor, got


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx: common.RunContext) -> common.Outcome:
    cfg, p, dev = ctx.cell.config, ctx.params, ctx.device
    arch = ctx.cell.arch
    trainer, state, step_fn, processor, got = checked_steps(ctx)
    marks = got.pop("marks")
    pool = window_pool(p, arch.vocab(cfg), ctx.seed, int(p["check_steps"]))
    marks(f"{len(pool)} window batches drawn")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    tr = DeviceTrace(ctx.trace and dev.type == "cuda")
    layouts: List = []
    steps = 0
    with tr:  # the profiler starts before the clock does
        setup_s = common.process_age_s()
        t0 = time.perf_counter()
        while steps == 0 or time.perf_counter() - t0 < ctx.seconds:
            raw = pool[steps % len(pool)]
            with tr.phase("input pipeline"):
                batch = program_batch(processor, raw)
            with tr.phase("train step"):
                step_fn(state.params, state.opt_state, batch)
            if ctx.trace:
                layouts.append(raw)
            steps += 1
    window = tr.window_s
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    pairs = steps * int(p["pairs"])

    facts: Dict = {"trace": tr, "window_s": window, "steps": steps}
    if ctx.trace:
        ref = ctx.cell.reference_module()
        forwards = []
        for raw in layouts:
            rb = reference_batch(ref, cfg, arch.vocab(cfg), raw)
            forwards.append(([model_work.page_layout(pg) for pg in rb["pages"]],
                             [len(q) for q in raw["queries"]]))
        passes = 2 if p["remat"] else 1  # remat runs each layer's forward twice
        facts.update(config=cfg, arch=arch, forwards=forwards,
                     attention_kernels=ATTENTION_KERNELS,
                     **model_work.window_work(arch, cfg, forwards, passes, True))
    del state, trainer, step_fn, batch, pool
    free(dev)
    t_ref = time.perf_counter()
    want = reference_readings(ctx)
    t_ref = time.perf_counter() - t_ref
    nums, reported = compare(ctx.cell.reference_module(), got, want, float(p["temperature"]))
    lim = p["limits"]
    return common.Outcome(
        attempted=steps, failed=0,
        end_to_end={"train_pairs_per_s": pairs / window, "setup_s": setup_s},
        compared={k: common.Limit(v, float(lim[k])) for k, v in nums.items()},
        memory_peak_bytes=int(peak), facts=facts,
        notes=[marks.note(), f"reference {t_ref:.1f} s",
               f"window {window:.3f} s, {steps} steps of {p['pairs']} pairs",
               f"losses program {got['loss']} reference {want['loss']}",
               "reported, not compared: " + json.dumps(reported)])


def control(ctx: common.RunContext) -> Dict[str, float]:
    """The control's readings of the numbers compared: the reference in fp8
    in the program's place, against the reference in f32, at step 1."""
    fp8 = faults(ctx, ("fp8",))["fp8"]
    return {k: v for k, v in fp8.items() if k in ctx.params["limits"]}


def faults(ctx: common.RunContext, which=("fp8", "half_batch", "token_altered")) -> Dict:
    """Readings on one seed, from which PERF.md sets the limits (read by
    ``control.py``; the benchmark's runs do not run this).

    ``program``: the program's own numbers but ``step_gap`` (which needs the
    reference's three steps; every run of the cell reads it), against the
    reference's first step, with the worst gradient leaf beside.
    ``half_batch_in_loss``: ``loss_gap`` of the program's steps had their
    loss taken the mean over the first half of the pairs only. Then, for each
    name in ``which``, ``embed_gap`` and ``grad_gap`` of the reference's
    first step put in the program's place: in fp8 (``"fp8"``, the control),
    or with ``"half_batch"`` or ``"token_altered"`` planted in it.
    ``step_gap``'s readings come from :func:`compare` over three steps; a
    step that leaves the state unchanged reads 1 on it by its definition."""
    cfg, p, dev = ctx.cell.config, ctx.params, ctx.device
    arch, ref = ctx.cell.arch, ctx.cell.reference_module()
    temp = float(p["temperature"])
    trainer, state, step_fn, processor, got = checked_steps(ctx, plant_half=True)
    got.pop("marks")
    del trainer, state, step_fn, processor
    free(dev)
    vocab = arch.vocab(cfg)
    batch = reference_batch(ref, cfg, vocab, raw_batch(p, vocab, ctx.seed, 0))

    def first_step(precision="f32", fault=None) -> Dict:
        params = weights.draw(arch.leaves(cfg), ctx.seed, dev)
        return ref.train_steps(cfg, params, [batch], float(p["lr"]), temp, precision, fault)

    want = first_step()
    nums, reported = compare(ref, got, want, temp)
    out = {"program": {**nums, **reported}, "half_batch_in_loss": {
        "loss_gap": max(loss_gaps(ref, got["half_loss"], got["loss_inputs"], temp))}}
    skip = ref.rounding_leaves(want["grad_norms"])
    for name in which:
        precision, fault = ("fp8", None) if name == "fp8" else ("f32", name)
        r = first_step(precision, fault)
        grads = ref.leaf_gaps(r["grad_norms"], want["grad_norms"], skip)
        out[name] = {"embed_gap": ref.embedding_gap(r["embeddings"], want["embeddings"]),
                     "grad_gap": float(np.median(list(grads.values())))}
        free(dev)
    return out
