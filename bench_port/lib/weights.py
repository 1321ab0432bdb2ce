"""A model's parameters from its table of leaves and a seed, drawn on the
card in a few large calls.

The table of leaves (name, shape, how it is scaled) is the harness's own,
made from the configuration's published sizes by its architecture's
``leaves`` (``bench_port/arch/``); :func:`check_names` holds
it against the program's module tree, so the two cannot drift apart
silently. The values are one flat f32 buffer of standard normals drawn in
chunks of ``CHUNK`` by a ``torch.Generator`` on the device, each leaf a
slice of it scaled in place: a matrix by ``1 / sqrt(fan_in)``, a table by
0.02, a bias by 0.02, a norm's scale ``1 + 0.1 z`` and a LayerNorm's bias
``0.02 z`` (biases and scales that are not 0 and 1, so the comparison
covers them). The reference draws the same buffer again from the seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import torch

CHUNK = 1 << 26  # elements a draw: 256 MB of f32


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    kind: str  # "matrix" | "table" | "bias" | "scale" | "ln_bias"

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def _scale_(t: torch.Tensor, leaf: Leaf) -> None:
    if leaf.kind == "matrix":
        t.mul_(leaf.shape[-1] ** -0.5)
    elif leaf.kind == "scale":
        t.mul_(0.1).add_(1.0)
    else:  # table, bias, ln_bias
        t.mul_(0.02)


def normals(total: int, seed: int, device) -> Iterator[torch.Tensor]:
    """The flat buffer's standard normals, chunk by chunk (always the same
    chunks, so a later pass draws the same values)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for s in range(0, total, CHUNK):
        yield torch.randn((min(CHUNK, total - s),), generator=gen, device=device,
                          dtype=torch.float32)


def draw(table: List[Leaf], seed: int, device
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(flat f32 buffer, {name: view of it}) of every leaf, scaled."""
    total = sum(leaf.numel for leaf in table)
    flat = torch.empty((total,), dtype=torch.float32, device=device)
    pos = 0
    for z in normals(total, seed, device):
        flat[pos:pos + z.numel()] = z
        pos += z.numel()
    params, pos = {}, 0
    for leaf in table:
        view = flat[pos:pos + leaf.numel].view(leaf.shape)
        _scale_(view, leaf)
        params[leaf.name] = view
        pos += leaf.numel
    return flat, params


def initial_norms_of_change(table: List[Leaf], seed: int, params: Dict[str, torch.Tensor]
                            ) -> Dict[str, float]:
    """{leaf: ||params[leaf] - its initial value||}, the initial values drawn
    again from the seed chunk by chunk (no copy of the model is held)."""
    total = sum(leaf.numel for leaf in table)
    device = next(iter(params.values())).device
    sq = {leaf.name: torch.zeros((), dtype=torch.float64, device=device) for leaf in table}
    it = normals(total, seed, device)
    buf, buf_start = next(it), 0
    pos = 0
    for leaf in table:
        cur = params[leaf.name].detach().reshape(-1)
        done = 0
        while done < leaf.numel:
            while pos + done >= buf_start + buf.numel():
                buf_start += buf.numel()
                buf = next(it)
            a = pos + done - buf_start
            n = min(leaf.numel - done, buf.numel() - a)
            z = buf[a:a + n].clone()
            _scale_(z, leaf)
            d = cur[done:done + n].float() - z
            sq[leaf.name] += (d.double() * d.double()).sum()
            done += n
        pos += leaf.numel
    return {k: float(v.sqrt()) for k, v in sq.items()}


def check_names(params: Dict[str, torch.Tensor], model_state: Dict[str, torch.Tensor]) -> None:
    """Raise unless the table has exactly the program model's leaves and shapes."""
    want = {k: tuple(v.shape) for k, v in model_state.items()}
    have = {k: tuple(v.shape) for k, v in params.items()}
    if want != have:
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        shapes = sorted(k for k in set(want) & set(have) if want[k] != have[k])[:5]
        raise ValueError(f"weight table does not fit the model: missing {missing}, "
                         f"unexpected {extra}, other shapes {shapes}")
