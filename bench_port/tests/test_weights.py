"""The weight draw (``lib/weights.py``) against the algorithm it replaced:
one flat f32 buffer of the seed's normals, each leaf a view of it scaled in
place, then cast once to the dtype it is held in. The values are the same
bit for bit, in every dtype and across the chunks' boundaries; the draw
allocates nothing larger than one chunk besides the leaves it returns; and a
model of Kimi-VL-A3B-Instruct's 16,072,374,000 parameters is drawn into bf16
on the card within its bf16 bytes and half a GiB."""

from __future__ import annotations

import weakref

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bench_port.lib import common, weights
from bench_port.lib.weights import Leaf
from bench_port.tests import tiny

# leaves of every kind, each longer or shorter than a chunk of 300 elements,
# so that pieces start and end inside leaves and chunks alike
STRADDLING = [Leaf("embed", (40, 25), "table"), Leaf("a.weight", (17, 23), "matrix"),
              Leaf("a.bias", (17,), "bias"), Leaf("n.scale", (299,), "scale"),
              Leaf("n.bias", (301,), "ln_bias"), Leaf("b.weight", (3, 100), "matrix"),
              Leaf("c.weight", (1, 1), "matrix"), Leaf("d.weight", (64, 64), "matrix")]


def _table(name):
    if name == "straddling":
        return STRADDLING
    cfg = tiny.config(name)
    return common.arch_module(cfg).leaves(cfg)


def _one_flat_buffer(table, dtype_of):
    """The draw as it was: the whole model as one f32 buffer, each leaf a
    view scaled in place, then ``.to`` its dtype."""
    total = sum(leaf.numel for leaf in table)
    flat = torch.empty((total,), dtype=torch.float32)
    pos = 0
    for z in weights.normals(total, tiny.SEED, tiny.CPU):
        flat[pos:pos + z.numel()] = z
        pos += z.numel()
    out, pos = {}, 0
    for leaf in table:
        view = flat[pos:pos + leaf.numel].view(leaf.shape)
        weights._scale_(view, leaf)
        out[leaf.name] = view.to(dtype_of(leaf.name))
        pos += leaf.numel
    return out


def _bits(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _same_bits(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32, "default": None}


@pytest.mark.parametrize("chunk", [weights.CHUNK, 300], ids=["chunk_2e26", "chunk_300"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["colqwen25-v0.2", "colsmol-500m", "straddling"])
def test_draw_is_the_one_flat_buffer_bit_for_bit(name, dtype, chunk, monkeypatch):
    monkeypatch.setattr(weights, "CHUNK", chunk)
    table = _table(name)
    dt = DTYPES[dtype]
    dtypes = None if dt is None else {leaf.name: dt for leaf in table}
    got = weights.draw(table, tiny.SEED, tiny.CPU, dtypes)
    _same_bits(got, _one_flat_buffer(table, lambda _: dt or torch.float32))


@pytest.mark.parametrize("chunk", [weights.CHUNK, 300], ids=["chunk_2e26", "chunk_300"])
@pytest.mark.parametrize("name", ["colqwen25-v0.2", "colsmol-500m"])
def test_serving_state_is_the_old_cast_of_the_flat_buffer(name, chunk, monkeypatch):
    """The ingest kind's serving weights: the meta model's dtypes (bf16
    matrices and tables, f32 norms), mixed in one draw."""
    from visual_rag_tpu_torch.models.colvlm import ColVLM

    from bench_port.kinds import ingest

    monkeypatch.setattr(weights, "CHUNK", chunk)
    cfg = tiny.config(name)
    arch = common.arch_module(cfg)
    pcfg = arch.program_config(cfg)
    dtypes = {k: v.dtype for k, v in ColVLM(pcfg, device="meta").state_dict().items()}
    assert {torch.bfloat16, torch.float32} <= set(dtypes.values())
    got = ingest.serving_state(arch.leaves(cfg), pcfg, tiny.SEED, tiny.CPU)
    _same_bits(got, _one_flat_buffer(arch.leaves(cfg), dtypes.__getitem__))


def test_serving_state_checks_the_table_before_drawing(monkeypatch):
    from bench_port.kinds import ingest

    def no_draw(*a, **kw):
        raise AssertionError("drew before the table was checked")

    monkeypatch.setattr(weights, "draw", no_draw)
    cfg = tiny.config("colsmol-500m")
    arch = common.arch_module(cfg)
    table = arch.leaves(cfg)
    with pytest.raises(ValueError, match="does not fit the model"):
        ingest.serving_state(table[:-1], arch.program_config(cfg), tiny.SEED, tiny.CPU)


@pytest.mark.parametrize("seed", [0, tiny.SEED])
def test_norms_of_change_walk_the_same_stream(seed, monkeypatch):
    monkeypatch.setattr(weights, "CHUNK", 300)
    params = weights.draw(STRADDLING, seed, tiny.CPU)
    assert set(weights.initial_norms_of_change(STRADDLING, seed, params).values()) == {0.0}
    params["n.bias"].add_(0.5)
    norms = weights.initial_norms_of_change(STRADDLING, seed, params)
    assert norms.pop("n.bias") == pytest.approx(0.5 * 301 ** 0.5, rel=1e-6)
    assert set(norms.values()) == {0.0}


class _Allocations(TorchDispatchMode):
    """Every new storage an operation returns (factories such as ``empty``
    and ``randn``, and any operation that is neither in place nor a view):
    its operation, address and bytes; and the most bytes alive at once (a
    storage lives while the tensor that brought it, or a view of it, does)."""

    def __init__(self):
        super().__init__()
        self.new, self.alive, self.peak = [], [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {a.untyped_storage().data_ptr() for a in _tensors((args, kwargs))}
        for t in _tensors(out):
            st = t.untyped_storage()
            if st.data_ptr() not in seen:
                self.new.append((str(func), st.data_ptr(), st.nbytes()))
                self.alive.append((weakref.ref(t), st.nbytes()))
        self.alive = [(r, n) for r, n in self.alive if r() is not None]
        self.peak = max(self.peak, sum(n for _, n in self.alive))
        return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


@pytest.mark.parametrize("dtype", ["bf16", "f32", "default"])
def test_draw_allocates_one_chunk_at_most_besides_the_leaves(dtype, monkeypatch):
    chunk = 256
    monkeypatch.setattr(weights, "CHUNK", chunk)
    table = [Leaf("embed", (64, 40), "table"), Leaf("w", (48, 30), "matrix"),
             Leaf("s", (700,), "scale"), Leaf("v", (30, 48), "matrix")]
    dt = DTYPES[dtype]
    with _Allocations() as rec:
        got = weights.draw(table, tiny.SEED, tiny.CPU,
                           None if dt is None else {leaf.name: dt for leaf in table})
    leaves = {v.untyped_storage().data_ptr(): v.untyped_storage().nbytes()
              for v in got.values()}
    others = [(f, n) for f, ptr, n in rec.new if ptr not in leaves]
    assert others and max(n for _, n in others) == chunk * 4, others
    assert rec.peak <= sum(leaves.values()) + chunk * 4
    assert sum(leaf.numel for leaf in table) > 20 * chunk  # the leaves span many chunks


# Kimi-VL-A3B-Instruct's parameters, its 163840 x 2048 token table the largest leaf
KIMI_PARAMETERS = 16_072_374_000


def _kimi_sized_table():
    table = [Leaf("tok_embed.weight", (163840, 2048), "table")]
    n, rest = divmod(KIMI_PARAMETERS - 163840 * 2048, 1408 * 2048)
    table += [Leaf(f"experts.{i}.weight", (1408, 2048), "matrix") for i in range(n)]
    table.append(Leaf("rest.scale", (rest,), "scale"))
    return table


@pytest.mark.cuda
def test_a_16b_model_draws_into_bf16_within_its_bytes_and_half_a_gib():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    table = _kimi_sized_table()
    assert sum(leaf.numel for leaf in table) == KIMI_PARAMETERS
    assert max(leaf.numel for leaf in table) == 163840 * 2048
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    got = weights.draw(table, tiny.SEED, dev, {leaf.name: torch.bfloat16 for leaf in table})
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    held = KIMI_PARAMETERS * 2
    print(f"\n{KIMI_PARAMETERS} parameters in bf16: {held} bytes ({held / 2**30:.4f} GiB); "
          f"the draw's peak {peak} bytes ({peak / 2**30:.4f} GiB), "
          f"{(peak - held) / 2**20:.2f} MiB over; {torch.cuda.get_device_name(dev)}")
    assert peak <= held + 2**29
    # spot values: the table's first chunk and the last leaf, as the one
    # flat buffer gave them
    first = next(weights.normals(weights.CHUNK, tiny.SEED, dev))
    want = first.mul_(0.02).to(torch.bfloat16)
    assert torch.equal(_bits(got["tok_embed.weight"].reshape(-1)[:weights.CHUNK]), _bits(want))
    del first, want
    last = table[-1]
    for tail in weights.normals(KIMI_PARAMETERS, tiny.SEED, dev):
        pass
    z = tail[tail.numel() - last.numel:].clone()
    del tail
    weights._scale_(z, last)
    assert torch.equal(_bits(got[last.name]), _bits(z.to(torch.bfloat16)))
