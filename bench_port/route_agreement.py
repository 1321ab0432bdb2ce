"""How often the program's expert choices differ from the plain reference's,
on pages of a routed-expert configuration's ingest cell.

    python3 bench_port/route_agreement.py --workload kimivl.ingest.b8 --seed <n> [--pages 2]

The program embeds the cell's first batch of each page size (8 pages, as
the window does) and records every routed layer's choices; it is freed, and
the plain reference embeds the first ``--pages`` pages of each batch in f32,
recording its own. Each side routes its own hidden states. Prints one JSON
line: for each page and in all, the (token, routed layer) pairs and the
share of them whose set of ``top_k`` experts differs (also by routed layer,
first to last: a flip changes the hidden state the next layers route), the
share of single choices that differ, and the reference's own margin at the pairs that
differ (its k-th largest score + bias less its (k+1)-th: how near a tie
each flip was). Needs the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import run  # noqa: E402,F401  (sets the build caches as run.py does)
from bench_port.lib import common, weights  # noqa: E402


def program_routes(ctx, batches):
    """{(batch, page): [per routed layer: int64 [valid tokens, top_k]]}."""
    import torch

    from bench_port.kinds import ingest
    from visual_rag_tpu_torch.models.colvlm import RoutedMoE
    from visual_rag_tpu_torch.models.embedder import VisualEmbedder

    cfg, p, dev = ctx.cell.config, ctx.params, ctx.device
    pcfg = ctx.cell.arch.program_config(cfg)
    params = ingest.serving_state(ctx.cell.arch.leaves(cfg), pcfg, ctx.seed, dev)
    emb = VisualEmbedder(p["model_name"], batch_size=int(p["batch"]), config=pcfg,
                         params=params, device=dev)
    del params
    layers = [m for m in emb.model.modules() if isinstance(m, RoutedMoE)]
    seen = []
    for layer in layers:
        route = layer.route

        def record(x, route=route):
            idx, w = route(x)
            seen.append(idx)
            return idx, w

        layer.route = record
    out = {}
    for b, pages in enumerate(batches):
        seen.clear()
        proc = emb.processor.process_images(pages)
        lengths = proc.attn_mask.sum(1).tolist()
        emb.embed_images(pages)
        for k, n in enumerate(lengths):
            out[b, k] = [s.view(len(pages), -1, s.shape[-1])[k, :n].cpu() for s in seen]
    del emb, layers, seen
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def reference_routes(ctx, batches, per_batch):
    """As :func:`program_routes` for the reference, with each flip's margin."""
    import torch

    cfg, dev = ctx.cell.config, ctx.device
    ref = ctx.cell.reference_module()
    model = ref.Reference(cfg, weights.draw(ctx.cell.arch.leaves(cfg), ctx.seed, dev))
    route, seen = model.route, []

    def record(i, x):
        idx, w = route(i, x)
        r = f"layers.{i}.mlp.router"
        top = torch.topk(torch.sigmoid(x @ model.p[f"{r}.weight"].T) + model.p[f"{r}.bias"],
                         idx.shape[1] + 1).values
        seen.append((idx.cpu(), (top[:, -2] - top[:, -1]).cpu()))
        return idx, w

    model.route = record
    out = {}
    with ref.exact_f32(), torch.no_grad():
        for b, pages in enumerate(batches):
            for k in range(per_batch):
                seen.clear()
                model.page(ref.process_page(pages[k], cfg), dev)
                out[b, k] = list(seen)
    return out


def compare(prog, refr):
    pairs = differ = choices = choice_differ = 0
    margins = []
    pages = {}
    by_layer: dict = {}
    for key, ref_layers in refr.items():
        p_pairs = p_differ = 0
        for layer, (got, (want, margin)) in enumerate(zip(prog[key], ref_layers)):
            a, b = got.sort(-1).values, want.sort(-1).values
            rows = (a != b).any(-1)
            p_pairs += a.shape[0]
            p_differ += int(rows.sum())
            n, d = by_layer.get(layer, (0, 0))
            by_layer[layer] = (n + a.shape[0], d + int(rows.sum()))
            choices += a.numel()
            choice_differ += sum(len(set(x.tolist()) - set(y.tolist()))
                                 for x, y in zip(a[rows], b[rows]))
            margins += margin[rows].tolist()
        pages[f"{key[0]}.{key[1]}"] = {"pairs": p_pairs, "differ": p_differ / p_pairs}
        pairs += p_pairs
        differ += p_differ
    margins.sort()
    return {"pages": pages, "pairs": pairs, "pairs_differ": differ / pairs,
            "choices_differ": choice_differ / choices,
            "layers_differ": [d / n for _, (n, d) in sorted(by_layer.items())],
            "margin_at_flips": {q: margins[int(q * (len(margins) - 1))] for q in (0.5, 0.9, 1.0)}
            if margins else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pages", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        common.log("route_agreement needs the card")
        return 3
    from bench_port.kinds import ingest

    cell = common.load_cell(args.workload)
    ctx = common.RunContext(cell, args.seed, 0.0, False, torch.device("cuda", 0))
    p = cell.traffic
    pool = ingest.page_pool(p, args.seed)
    call = ingest.call_pages(p, pool, 0)
    bs = int(p["batch"])
    batches = [call[i:i + bs] for i in range(0, len(call), bs)]
    prog = program_routes(ctx, batches)
    refr = reference_routes(ctx, batches, args.pages)
    print(json.dumps({"workload": cell.name, "seed": args.seed, "card": run.card_line(),
                      **compare(prog, refr)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
