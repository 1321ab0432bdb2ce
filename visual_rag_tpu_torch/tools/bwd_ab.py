"""Time B4 and B5 (K10's backward) of one source tree, to compare two trees on one card.

    python visual_rag_tpu_torch/tools/bwd_ab.py <tree root> <tag> [--sdpa]

imports ``visual_rag_tpu_torch`` from ``<tree root>`` (for example the parent
commit unpacked with ``git archive HEAD | tar -x -C build/kernels/parent``),
builds that tree's kernels, and prints one line: ``<tag>`` and the
CUDA-event ms of B4 (``flash_attention_bwd_dkv``) and B5
(``flash_attention_bwd_dq``), 20 launches each after a warm one, queued
behind a ~10 ms sleep kernel so that the host's time per call (which exceeds
the card's at the query shapes) stays out of the measurement, in bf16 at
the shapes of ``chip_smoke.py`` phases 14-16: ColSmol-500M's 17-tile vision
(T 17408, 12 heads of 64, a segment a tile), 4 pages' text (T 896, 15 on 5,
causal) and 4 queries (T 30); ColPali-v1.3's vision at 1 and 4 pages (T 1024,
16 heads of 72), 4 pages' text (T 1088, 8 on 1 of 256) and 4 queries (T 32);
ColQwen2.5-v0.2's window layer at 1 and 4 A4 pages (T 4096, 16 heads of 80,
the processor's window ids), full layer at 1 page, 4 pages' text (T 1024, 16
on 2 of 128, causal) and 4 queries (T 25). lse and di come from the tree's
own forward. With ``--sdpa`` it also prints, a shape a line, SDPA's
backward alone (the same boolean mask, kv heads repeated) and the bounds of
B4 and B5 as ``chip_smoke.py`` computes them (8 and 6 x Dh flops an allowed
pair and head at 989 TFLOP/s, or the bytes read and written once at 3.35
TB/s, whichever is larger). Run the trees in turns in
one call (parent, change, change, parent): two calls may land on two cards.
"""

from __future__ import annotations

import sys


def shapes(dev):
    """{name: (b, t, hq, hkv, dh, seg, causal)} in bf16 (module docstring)."""
    import numpy as np
    import torch

    from visual_rag_tpu_torch.models.attention import segment_ids
    from visual_rag_tpu_torch.models.processors import ImageProcessor

    def prefix(lengths, t):
        return (torch.arange(t, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]
                ).to(torch.int32)

    tiles = (torch.arange(17408, device=dev)[None] // 1024 + 1).to(torch.int32)
    page = ImageProcessor(backend="colqwen2.5", image_token_id=1, patch_pixels=12,
                          max_visual_tokens=1024).process_images(
        [np.zeros((1170, 827, 3), np.float32)])  # an A4 page: 74 x 54 patches
    valid = torch.from_numpy(page.patch_mask).to(dev)
    windows = segment_ids(valid, torch.from_numpy(page.window_ids).to(dev))
    t_page = valid.shape[1]
    return {
        "smol-vision17": (1, 17408, 12, 12, 64, tiles, False),
        "smol-text13": (4, 896, 15, 5, 64, prefix([836] * 4, 896), True),
        "smol-queries": (4, 30, 15, 5, 64, prefix([30, 21, 12, 25], 30), True),
        "cp-vision1": (1, 1024, 16, 16, 72, prefix([1024], 1024), False),
        "cp-vision4": (4, 1024, 16, 16, 72, prefix([1024] * 4, 1024), False),
        "cp-text4": (4, 1088, 8, 1, 256, prefix([1028] * 4, 1088), False),
        "cp-queries": (4, 32, 8, 1, 256, prefix([32, 21, 12, 25], 32), False),
        "cq-window1": (1, t_page, 16, 16, 80, windows, False),
        "cq-window4": (4, t_page, 16, 16, 80, windows.repeat(4, 1), False),
        "cq-full1": (1, t_page, 16, 16, 80, valid.to(torch.int32), False),
        "cq-text4": (4, 1024, 16, 2, 128, prefix([1007, 1008, 1012, 1007], 1024), True),
        "cq-queries": (4, 25, 16, 2, 128, prefix([25, 17, 9, 21], 25), True),
    }


def main(root: str, tag: str, sdpa: bool) -> None:
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from visual_rag_tpu_torch.ops.kernels import _build
    from visual_rag_tpu_torch.ops.kernels import flash_attention as fa

    _build.load_library()
    dev = torch.device("cuda", 0)

    def ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms: the host queues every launch before the first
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    out = []
    for name, (b, t, hq, hkv, dh, seg, causal) in shapes(dev).items():
        if dh not in getattr(fa, "KERNEL_HEAD_DIMS", (64,)):
            continue
        gen = torch.Generator(device=dev)
        gen.manual_seed(t + hq + 1)
        q, do = (torch.randn((b, t, hq, dh), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((b, t, hkv, dh), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        o, lse = fa.flash_attention_fwd(q, k, v, seg, causal=causal)
        di = fa.attention_di(o, do)
        kw = dict(causal=causal)
        b4 = ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, seg, do, lse, di, **kw))
        b5 = ms(lambda: fa.flash_attention_bwd_dq(q, k, v, seg, do, lse, di, **kw))
        out.append(f"{name} B4 {b4:.4f} B5 {b5:.4f}")
        if sdpa:
            rep = hq // hkv
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (
                q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)))
            mask = torch.stack([fa.allowed_pairs(s, causal) for s in seg])[:, None]
            o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            lib = ms(lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), do.transpose(1, 2),
                                                 retain_graph=True))
            pairs = int(mask.sum())  # allowed pairs of one head, over the batch
            ins = sum(x.numel() * x.element_size() for x in (q, k, v, do, lse, di, seg))
            b4_bound = max(8 * dh * pairs * hq / 989e12, (ins + 4 * k.numel()) / 3.35e12)
            b5_bound = max(6 * dh * pairs * hq / 989e12, (ins + 2 * q.numel()) / 3.35e12)
            print(f"{tag} {name}: SDPA backward {lib:.4f} ms; bound B4 {b4_bound * 1e3:.4f} ms, "
                  f"B5 {b5_bound * 1e3:.4f} ms ({pairs} allowed pairs a head)", flush=True)
            del qt, kt, vt, mask, o_sdpa
        del q, k, v, do, o, lse, di
        torch.cuda.empty_cache()
    print(tag, " | ".join(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], "--sdpa" in sys.argv[3:])
