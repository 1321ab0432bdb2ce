"""A model's parameters from its table of leaves and a seed, drawn on the
card in a few large calls.

The table of leaves (name, shape, how it is scaled) is the harness's own,
made from the configuration's published sizes by its architecture's
``leaves`` (``bench_port/arch/``); :func:`check_names` holds it against the
program's module tree, so the two cannot drift apart silently. The values
are one stream of standard normals in the table's order, drawn in chunks of
``CHUNK`` by a ``torch.Generator`` on the device: the leaves laid end to end
as one flat buffer, each its slice of the stream. A leaf's values are its
normals scaled in f32: a matrix by ``1 / sqrt(fan_in)``, a table by 0.02, a
bias by 0.02, a norm's scale ``1 + 0.1 z`` and a LayerNorm's bias ``0.02 z``
(biases and scales that are not 0 and 1, so the comparison covers them).

:func:`draw` writes each leaf straight into the tensor it is used as, cast
once from the scaled f32 values into the dtype asked for (the serving
dtypes, or f32 for the trainer's master weights and the reference). Besides
the leaves it returns, it holds one chunk of f32 at a time (256 MiB), so
drawing a model costs its bytes in the dtypes asked for and no more. The
reference draws the same values again from the seed, and
:func:`initial_norms_of_change` walks the same stream.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import torch

CHUNK = 1 << 26  # elements a draw: 256 MiB of f32


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
    """The stream's standard normals, chunk by chunk (always the same
    chunks, so a later pass draws the same values)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for s in range(0, total, CHUNK):
        yield torch.randn((min(CHUNK, total - s),), generator=gen, device=device,
                          dtype=torch.float32)


def _walk(table: List[Leaf], seed: int, device,
          visit: Callable[[Leaf, int, torch.Tensor], None]) -> None:
    """``visit(leaf, start, values)`` for each piece of a leaf that one chunk
    covers, in the stream's order: ``values`` are the leaf's flat elements
    ``start`` onwards, scaled in f32 in place in the chunk. The chunk is
    dropped before the next is drawn, so ``visit`` keeps no reference."""
    k = done = 0  # the leaf the walk is in, and its elements already visited
    for z in normals(sum(leaf.numel for leaf in table), seed, device):
        a = 0
        while a < z.numel():
            leaf = table[k]
            n = min(leaf.numel - done, z.numel() - a)
            piece = z[a:a + n]
            _scale_(piece, leaf)
            visit(leaf, done, piece)
            a, done = a + n, done + n
            if done == leaf.numel:
                k, done = k + 1, 0
        del z, piece


def draw(table: List[Leaf], seed: int, device,
         dtypes: Optional[Mapping[str, torch.dtype]] = None) -> Dict[str, torch.Tensor]:
    """{name: leaf} of every leaf, scaled, each in ``dtypes[name]`` (f32
    without ``dtypes``)."""
    params = {leaf.name: torch.empty(leaf.shape, device=device,
                                     dtype=torch.float32 if dtypes is None else dtypes[leaf.name])
              for leaf in table}

    def write(leaf: Leaf, start: int, values: torch.Tensor) -> None:
        params[leaf.name].view(-1)[start:start + values.numel()].copy_(values)

    _walk(table, seed, device, write)
    return params


def initial_norms_of_change(table: List[Leaf], seed: int, params: Dict[str, torch.Tensor]
                            ) -> Dict[str, float]:
    """{leaf: ||params[leaf] - its initial value||}, the initial values drawn
    again from the seed chunk by chunk (no copy of the model is held)."""
    device = next(iter(params.values())).device
    sq = {leaf.name: torch.zeros((), dtype=torch.float64, device=device) for leaf in table}

    def add(leaf: Leaf, start: int, values: torch.Tensor) -> None:
        cur = params[leaf.name].detach().reshape(-1)
        d = (cur[start:start + values.numel()].float() - values).double()
        sq[leaf.name] += (d * d).sum()

    _walk(table, seed, device, add)
    return {k: float(v.sqrt()) for k, v in sq.items()}


def check_names(table: List[Leaf], model_state: Mapping[str, torch.Tensor]) -> None:
    """Raise unless the table has exactly the program model's leaves and
    shapes (a meta model's state dict will do: nothing is drawn)."""
    want = {k: tuple(v.shape) for k, v in model_state.items()}
    have = {leaf.name: tuple(leaf.shape) for leaf in table}
    if want != have:
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        shapes = sorted(k for k in set(want) & set(have) if want[k] != have[k])[:5]
        raise ValueError(f"weight table does not fit the model: missing {missing}, "
                         f"unexpected {extra}, other shapes {shapes}")
