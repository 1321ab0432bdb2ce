"""Contrastive fine-tuning CLI for the port's ColVLM (late-interaction InfoNCE).

Counterpart of ``scripts/train_colvlm.py``, on one device:

    python -m visual_rag_tpu_torch.cli.train_colvlm --synthetic --device cuda
    python -m visual_rag_tpu_torch.cli.train_colvlm --model vidore/colpali-v1.3 \\
        --synthetic --device cuda --batch-size 4
    python -m visual_rag_tpu_torch.cli.train_colvlm --data ./pairs \\
        --model vidore/colSmol-500M --batch-size 8 --steps 500 --device cuda \\
        --checkpoint-dir ckpts --save-every 100

Data (``--data DIR``): ``DIR/pairs.jsonl``, one JSON object a line,
``{"query": "...", "image": "pages/p3.npy"}``; images are ``.npy`` [H, W, 3]
arrays (or anything PIL opens, where PIL is installed), relative to DIR.
Batches come from the port's ``ImageProcessor`` with its window ids, as the
JAX CLI's ``data_batches`` builds them. ``--synthetic`` trains on one
repeated batch: with ``--tiny`` the JAX package's ``synthetic_batch``; at a
model's full width, random 2048 x 512 pages (5 ColSmol tiles; ColPali's
processor resizes them to 448 x 448, 1024 patches) and random queries
through the processor (the JAX ``synthetic_batch`` gives a pixel-shuffle
model fewer patches than a tile). The CLI trains without ``remat`` (the
JAX script has no such flag): full-width ColPali-v1.3 fits one 80 GB H100
at 4 pairs a step when no other process holds memory on the card.

``--device`` is required (``cuda`` or ``cpu``). Refused by name: a
``--mesh`` other than ``dp1`` (no mesh: one device), ``--scan-layers``,
``--ring-attention`` (ROADMAP A8) and ``--checkpoint`` (loading HF weights
waits for checkpoint files in the repository). Checkpoints are
``torch.save`` files under ``--checkpoint-dir/step_{step:08d}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np

SYNTHETIC_PAGE = (512, 2048)  # px: 5 ColSmol tiles (4 of 512 px and the global one)
QUERY_WORDS = ("revenue chart table figure page report annual growth market share cost "
               "region sales total quarter profit summary").split()


def load_pairs(data_dir: Path):
    pairs_file = data_dir / "pairs.jsonl"
    if not pairs_file.exists():
        raise SystemExit(f"no pairs.jsonl under {data_dir}")
    pairs = [json.loads(line) for line in pairs_file.read_text().splitlines() if line.strip()]
    if not pairs:
        raise SystemExit(f"{pairs_file} is empty")
    return pairs


def load_image(path: Path) -> np.ndarray:
    if path.suffix == ".npy":
        return np.load(path)
    try:
        from PIL import Image
    except ImportError:
        raise SystemExit(f"{path}: non-.npy images need PIL installed")
    return np.asarray(Image.open(path).convert("RGB"))


def processed_batch(processor, images, queries):
    """A training batch (numpy) from the port's processor, window ids included."""
    p = processor.process_images(images)
    q_ids, q_mask = processor.process_queries(queries)
    batch = {"query_ids": q_ids, "query_mask": q_mask, "page_ids": p.input_ids,
             "page_mask": p.attn_mask, "patches": p.patches, "patch_mask": p.patch_mask}
    if p.window_ids is not None:
        batch["window_ids"] = p.window_ids
    return batch


def data_batches(processor, pairs, batch_size, data_dir, seed):
    """Batches forever, the pairs reshuffled each epoch (``scripts/train_colvlm.py:65-89``)."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(pairs))
    while True:
        rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            chunk = [pairs[i] for i in order[s:s + batch_size]]
            yield processed_batch(processor, [load_image(data_dir / c["image"]) for c in chunk],
                                  [c["query"] for c in chunk])


def synthetic_batches(cfg, processor, batch_size, seed, tiny):
    from visual_rag_tpu_torch.models.train import synthetic_batch

    if tiny:
        batch = synthetic_batch(cfg, batch=batch_size, query_len=12, n_patches=64, seed=seed)
    else:
        rng = np.random.default_rng(seed)
        pages = [rng.random((*SYNTHETIC_PAGE, 3), dtype=np.float32) for _ in range(batch_size)]
        queries = [" ".join(rng.choice(QUERY_WORDS, int(rng.integers(4, 26))))
                   for _ in range(batch_size)]
        batch = processed_batch(processor, pages, queries)
    while True:
        yield batch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="vidore/colSmol-500M")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config (tests/smoke) instead of the model shape")
    ap.add_argument("--data", help="dir with pairs.jsonl (else synthetic)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--temperature", type=float, default=0.02)
    ap.add_argument("--mesh", default="dp1", help="only dp1: the port trains on one device")
    ap.add_argument("--scan-layers", action="store_true", help="refused (ROADMAP A8)")
    ap.add_argument("--ring-attention", action="store_true", help="refused (ROADMAP A8)")
    ap.add_argument("--checkpoint", help="HF weights to start from: refused until checkpoint "
                                         "files are in the repository")
    ap.add_argument("--tokenizer", help="local tokenizer.json / ckpt dir")
    ap.add_argument("--checkpoint-dir", default="train_ckpts")
    ap.add_argument("--save-every", type=int, default=0, help="0 = final only")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ema-decay", type=float, default=0.0,
                    help="keep an EMA of params (e.g. 0.999); saved under ema/")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", required=True, help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    if args.mesh != "dp1":
        ap.error(f"--mesh {args.mesh}: the port trains on one device (dp1); meshes are "
                 "ROADMAP A8")
    for flag, on in (("--scan-layers", args.scan_layers),
                     ("--ring-attention", args.ring_attention)):
        if on:
            ap.error(f"{flag}: not in the port yet (ROADMAP A8)")
    if args.checkpoint:
        ap.error("--checkpoint: loading HF weights waits for checkpoint files in the "
                 "repository (ROADMAP A1)")
    if not args.data and not args.synthetic:
        ap.error("pass --data DIR or --synthetic")
    return args


def main(argv=None):
    args = parse_args(argv)

    from visual_rag_tpu_torch.models.colvlm import ColVLMConfig
    from visual_rag_tpu_torch.models.embedder import (
        _CONFIG_BY_BACKEND,
        VisualEmbedder,
        detect_backend,
    )
    from visual_rag_tpu_torch.models.train import (
        Trainer,
        TrainState,
        ema_update,
        restore_train_state,
        save_train_state,
    )

    cfg = (ColVLMConfig.tiny() if args.tiny
           else _CONFIG_BY_BACKEND[detect_backend(args.model)]())
    trainer = Trainer(cfg, lr=args.lr, warmup=args.warmup, temperature=args.temperature,
                      device=args.device)
    # the embedder supplies the processor (its weights are never drawn here)
    processor = VisualEmbedder(args.model, config=cfg, tokenizer_path=args.tokenizer,
                               device=trainer.device).processor
    if args.data:
        pairs = load_pairs(Path(args.data))
        print(f"{len(pairs)} training pairs from {args.data}", flush=True)
        batches = data_batches(processor, pairs, args.batch_size, Path(args.data), args.seed)
    else:
        batches = synthetic_batches(cfg, processor, args.batch_size, args.seed, args.tiny)

    first = next(batches)
    state = trainer.init_state(args.seed)
    ckpt_dir = Path(args.checkpoint_dir)
    if args.resume and ckpt_dir.exists():
        state = restore_train_state(ckpt_dir, template=state)
        print(f"resumed from step {state.step}", flush=True)
    step_fn = trainer.make_train_step()
    params, opt_state = state.params, state.opt_state
    ema = ({k: v.detach().clone() for k, v in params.items()} if args.ema_decay else None)
    t0 = time.time()
    for step in range(state.step, args.steps):
        batch = first if step == state.step else next(batches)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if ema is not None:
            ema = ema_update(ema, params, args.ema_decay)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            rate = (step - state.step + 1) / (time.time() - t0)
            print(f"step {step:>5d}  loss {loss:.4f}  {rate:.2f} steps/s  "
                  f"{rate * len(batch['query_ids']):.2f} pairs/s", flush=True)
        if args.save_every and step and step % args.save_every == 0:
            print("saved", save_train_state(TrainState(params, opt_state, step), ckpt_dir),
                  flush=True)
    state = dataclasses.replace(state, params=params, opt_state=opt_state,
                                step=max(args.steps, state.step))
    print("saved", save_train_state(state, ckpt_dir), flush=True)
    if ema is not None:
        print("saved EMA", save_train_state(dataclasses.replace(state, params=ema),
                                            ckpt_dir / "ema"), flush=True)


if __name__ == "__main__":
    main()
