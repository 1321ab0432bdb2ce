"""Time K10 (flash attention) of one source tree, to compare two trees on one card.

    python visual_rag_tpu_torch/tools/k10_ab.py <tree root> <tag>

imports ``visual_rag_tpu_torch`` from ``<tree root>`` (for example the parent
commit unpacked with ``git archive HEAD | tar -x -C build/kernels/parent``),
builds that tree's kernels, and prints one line: ``<tag>`` and the
CUDA-event ms of K10 (20 launches after a warm one) at ColSmol-500M's three
shapes of ``chip_smoke.py`` phase 11 (head dim 64) and, where the tree has
the instances, ColPali-v1.3's three of phase 12 (head dims 72 and 256) and
ColQwen2.5-v0.2's four of phase 13 (head dims 80 and 128: an A4 page's 74 x
54 patches, padded to 4096, in a window layer with the processor's window
ids and in a full layer; 4 pages' causal text; 64 queries), in bf16 and
f32. Run the trees in turns in one call (parent, change, change, parent):
two calls may land on two cards.
"""

from __future__ import annotations

import sys


def main(root: str, tag: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from visual_rag_tpu_torch.models.attention import segment_ids
    from visual_rag_tpu_torch.models.processors import ImageProcessor
    from visual_rag_tpu_torch.ops.kernels import _build
    from visual_rag_tpu_torch.ops.kernels import flash_attention as fa

    _build.load_library()
    dev = torch.device("cuda", 0)

    def ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def prefix(lengths, t):
        return (torch.arange(t, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]
                ).to(torch.int32)

    tiles = torch.zeros((1, 17408), dtype=torch.int32, device=dev)
    tiles[0] = torch.arange(17408, device=dev) // 1024 + 1
    # ColQwen's window segments of an A4 portrait page (chip_smoke.colpali_pages)
    page = ImageProcessor(backend="colqwen2.5", image_token_id=1, patch_pixels=12,
                          max_visual_tokens=1024).process_images(
        [np.zeros((1170, 827, 3), np.float32)])
    valid = torch.from_numpy(page.patch_mask).to(dev)
    windows = segment_ids(valid, torch.from_numpy(page.window_ids).to(dev))
    shapes = {  # name: (b, t, hq, hkv, dh, seg, causal)
        "vision17": (1, 17408, 12, 12, 64, tiles, False),
        "text13": (4, 896, 15, 5, 64, prefix([836] * 4, 896), True),
        "queries": (64, 30, 15, 5, 64, prefix([5 + i % 26 for i in range(64)], 30), True),
        "cp-vision": (1, 1024, 16, 16, 72, prefix([1024], 1024), False),
        "cp-text4": (4, 1088, 8, 1, 256, prefix([1028] * 4, 1088), False),
        "cp-queries": (64, 32, 8, 1, 256, prefix([6 + i % 25 for i in range(64)], 32), False),
        "cq-window": (1, 4096, 16, 16, 80, windows, False),
        "cq-full": (1, 4096, 16, 16, 80, valid.to(torch.int32), False),
        "cq-text4": (4, 1024, 16, 2, 128, prefix([1007, 1008, 1012, 1007], 1024), True),
        "cq-queries": (64, 32, 16, 2, 128, prefix([6 + i % 25 for i in range(64)], 32), True),
    }
    dims = getattr(fa, "KERNEL_HEAD_DIMS", (64,))
    out = []
    for name, (b, t, hq, hkv, dh, seg, causal) in shapes.items():
        if dh not in dims:
            continue
        for dt in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev)
            gen.manual_seed(t + hq)
            q, k, v = (torch.randn((b, t, h, dh), generator=gen, device=dev).to(dt)
                       for h in (hq, hkv, hkv))
            t_ms = ms(lambda: fa.flash_attention(q, k, v, seg, causal=causal))
            out.append(f"{name}-{'bf16' if dt == torch.bfloat16 else 'f32'} {t_ms:.4f}")
    print(tag, " | ".join(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
