"""Time K10's two forwards (flash attention) of one source tree, to compare two trees on one card.

    python visual_rag_tpu_torch/tools/k10_ab.py <tree root> <tag> [--sdpa]

imports ``visual_rag_tpu_torch`` from ``<tree root>`` (for example the parent
commit unpacked with ``git archive HEAD | tar -x -C build/kernels/parent``),
builds that tree's kernels, and prints one line: ``<tag>`` and, at each shape,
the CUDA-event ms of the serving forward (``flash_attention``) and of the
forward that saves lse (``flash_attention_fwd``), 20 launches each after a
warm one, queued behind a ~10 ms sleep kernel so that the host's time per
call (which exceeds the card's at the query shapes) stays out of the
measurement, in bf16 and f32. The shapes are those of ``chip_smoke.py``
phases 11-16: ColSmol-500M's 17-tile vision (T 17408, 12 heads of 64, a
segment a tile), 4 pages' text (T 896, 15 on 5, causal), 64 queries (T 30)
and 4 queries; ColPali-v1.3's vision at 1 and 4 pages (T 1024, 16 heads of
72), 4 pages' text (T 1088, 8 on 1 of 256), 64 and 4 queries (T 32);
ColQwen2.5-v0.2's window layer at 1 and 4 A4 pages (T 4096, 16 heads of 80,
the processor's window ids), full layer at 1 page, 4 pages' text (T 1024, 16
on 2 of 128, causal), 64 queries (T 32) and 4 (T 25). With ``--sdpa`` it also
prints, a shape a line, SDPA's forward (the same boolean mask, kv heads
repeated) on plain inputs and on inputs that need grad, and the bound as
``chip_smoke.py`` computes it: 4 x Dh flops an allowed pair and head at 989
TFLOP/s (bf16) or 67 (f32), or q, k, v, the segment ids and the output (and
lse) read or written once at 3.35 TB/s, whichever is larger. Run the trees in
turns in one call (parent, change, change, parent): two calls may land on two
cards.
"""

from __future__ import annotations

import sys


def shapes(dev):
    """{name: (b, t, hq, hkv, dh, seg, causal)} (module docstring)."""
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
        "smol-queries64": (64, 30, 15, 5, 64, prefix([5 + i % 26 for i in range(64)], 30), True),
        "smol-queries4": (4, 30, 15, 5, 64, prefix([30, 21, 12, 25], 30), True),
        "cp-vision1": (1, 1024, 16, 16, 72, prefix([1024], 1024), False),
        "cp-vision4": (4, 1024, 16, 16, 72, prefix([1024] * 4, 1024), False),
        "cp-text4": (4, 1088, 8, 1, 256, prefix([1028] * 4, 1088), False),
        "cp-queries64": (64, 32, 8, 1, 256, prefix([6 + i % 25 for i in range(64)], 32), False),
        "cp-queries4": (4, 32, 8, 1, 256, prefix([32, 21, 12, 25], 32), False),
        "cq-window1": (1, t_page, 16, 16, 80, windows, False),
        "cq-window4": (4, t_page, 16, 16, 80, windows.repeat(4, 1), False),
        "cq-full1": (1, t_page, 16, 16, 80, valid.to(torch.int32), False),
        "cq-text4": (4, 1024, 16, 2, 128, prefix([1007, 1008, 1012, 1007], 1024), True),
        "cq-queries64": (64, 32, 16, 2, 128, prefix([6 + i % 25 for i in range(64)], 32), True),
        "cq-queries4": (4, 25, 16, 2, 128, prefix([25, 17, 9, 21], 25), True),
    }


def main(root: str, tag: str, sdpa: bool) -> None:
    # run as a file, this directory leads sys.path: the peaks come from this
    # tree without importing the package before <tree root> is put first
    from peaks import HBM_BYTES_PER_S, PEAK_OPS

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
        for dtype in (torch.bfloat16, torch.float32):
            dt = "bf16" if dtype == torch.bfloat16 else "f32"
            gen = torch.Generator(device=dev)
            gen.manual_seed(t + hq)
            q, k, v = (torch.randn((b, t, h, dh), generator=gen, device=dev).to(dtype)
                       for h in (hq, hkv, hkv))
            kw = dict(causal=causal)
            serve = ms(lambda: fa.flash_attention(q, k, v, seg, **kw))
            lse = ms(lambda: fa.flash_attention_fwd(q, k, v, seg, **kw))
            out.append(f"{name}-{dt} serve {serve:.4f} lse {lse:.4f}")
            if sdpa:
                rep = hq // hkv
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k.repeat_interleave(rep, 2),
                                                          v.repeat_interleave(rep, 2)))
                mask = torch.stack([fa.allowed_pairs(s, causal) for s in seg])[:, None]
                plain = ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
                qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
                grad = ms(lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask))
                pairs = int(mask.sum())  # allowed pairs of one head, over the batch
                nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q, seg))
                t_ops = 4 * dh * pairs * hq / PEAK_OPS[dt]
                bound = max(t_ops, nbytes / HBM_BYTES_PER_S) * 1e3
                lse_bound = max(t_ops, (nbytes + 4 * b * hq * t) / HBM_BYTES_PER_S) * 1e3
                print(f"{tag} {name} {dt}: SDPA forward {plain:.4f} ms, on inputs that need grad "
                      f"{grad:.4f} ms; bound {bound:.4f} ms, with lse {lse_bound:.4f} ms "
                      f"({pairs} allowed pairs a head)", flush=True)
                del qt, kt, vt, qg, kg, vg, mask
            del q, k, v
            torch.cuda.empty_cache()
    print(tag, " | ".join(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], "--sdpa" in sys.argv[3:])
