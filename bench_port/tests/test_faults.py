"""Each cell's check catches the faults its timed path can have: with the
path broken underneath (the look for a card skipped, everything else as a
run drives it, at a tiny size on the CPU), ``correct`` comes out false.

The model cells run their tiny configuration in f32 here, so a sound run
reads near zero and the cells' own limits hold; on the card the limits are
set from bf16 runs (PERF.md). The one-chip cells have no exchange between
chips to leave out.
"""

from __future__ import annotations

import pytest
import torch

from bench_port.tests import tiny


def _f32(cell):
    cell.config["torch_dtype"] = "float32"
    return cell


@pytest.fixture
def search_plan(monkeypatch):
    """Replace the plans' ``two_stage_plan`` by ``wrap(inner)``."""
    from visual_rag_tpu_torch.retrieval import plans

    def install(wrap):
        monkeypatch.setattr(plans, "two_stage_plan", wrap(plans.two_stage_plan))

    return install


def _altered(inner):
    def plan(*a, **kw):
        vals, idx = inner(*a, **kw)
        return vals + 1e-2 * (torch.arange(vals.shape[1]) == 0), idx  # one score a row
    return plan


def _half_batch(inner):
    def plan(s1, ragged, doc_mask, q1, q2, q3=None, **kw):
        vals, idx = inner(s1, ragged, doc_mask, q1, q2, q3, **kw)
        h = max(1, vals.shape[0] // 2)  # the second half gets the first half's answers
        vals, idx = vals.clone(), idx.clone()
        vals[h:2 * h], idx[h:2 * h] = vals[:h], idx[:h]
        return vals, idx
    return plan


def test_search_sound_run_is_correct():
    assert tiny.run(tiny.cell("colqwen25.search.b1024")).correct


@pytest.mark.parametrize("fault", [_altered, _half_batch], ids=["answer_altered", "half_batch"])
def test_search_fault_is_caught(fault, search_plan):
    search_plan(fault)
    assert not tiny.run(tiny.cell("colqwen25.search.b1024")).correct


def test_train_sound_run_is_correct():
    assert tiny.run(_f32(tiny.cell("colqwen25.train.b4"))).correct


def test_train_state_left_unchanged_is_caught(monkeypatch):
    from visual_rag_tpu_torch.models.train import AdamW

    real = AdamW.update

    def frozen(self, grads, state, params):
        saved = {k: p.detach().clone() for k, p in params.items()}
        state = real(self, grads, state, params)  # the moments move, the weights do not
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])
        return state

    monkeypatch.setattr(AdamW, "update", frozen)
    out = tiny.run(_f32(tiny.cell("colqwen25.train.b4")))
    assert not out.correct and out.compared["step_gap"].value > 0.9


def _half_before_the_forward(monkeypatch):
    from visual_rag_tpu_torch.models.train import Trainer

    real = Trainer._loss_fn

    def half(self, params, batch):
        n = max(2, batch["query_ids"].shape[0] // 2)
        return real(self, params, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(Trainer, "_loss_fn", half)


def _half_in_the_loss(monkeypatch):
    """The embeddings are the whole batch's and right; only the loss takes
    the mean over the first half of the pairs."""
    from visual_rag_tpu_torch.models import train as train_mod

    real = train_mod.colbert_infonce_loss

    def half(q_emb, q_mask, p_emb, p_mask, **kw):
        h = max(1, q_emb.shape[0] // 2)
        return real(q_emb[:h], q_mask[:h], p_emb[:h], p_mask[:h], **kw)

    monkeypatch.setattr(train_mod, "colbert_infonce_loss", half)


@pytest.mark.parametrize("plant", [_half_before_the_forward, _half_in_the_loss],
                         ids=["before_the_forward", "in_the_loss"])
def test_train_half_batch_is_caught(plant, monkeypatch):
    plant(monkeypatch)
    assert not tiny.run(_f32(tiny.cell("colqwen25.train.b4"))).correct


def test_train_token_altered_is_caught(monkeypatch):
    from visual_rag_tpu_torch.models.colvlm import ColVLM

    real = ColVLM._project

    def altered(self, h, mask):
        e = real(self, h, mask)
        return torch.cat([e[:, :1].flip(-1), e[:, 1:]], dim=1)  # the first token's embedding

    monkeypatch.setattr(ColVLM, "_project", altered)
    assert not tiny.run(_f32(tiny.cell("colqwen25.train.b4"))).correct


def test_ingest_sound_run_is_correct():
    assert tiny.run(_f32(tiny.cell("colsmol.ingest.b8"))).correct


def test_ingest_answer_altered_is_caught(monkeypatch):
    from visual_rag_tpu_torch.models.embedder import VisualEmbedder

    real = VisualEmbedder.embed_images

    def altered(self, images, *a, **kw):
        embs, infos = real(self, images, *a, **kw)
        embs[0] = embs[0].copy()
        embs[0][0] = embs[0][0][::-1]  # one token row of each call's first page
        return embs, infos

    monkeypatch.setattr(VisualEmbedder, "embed_images", altered)
    assert not tiny.run(_f32(tiny.cell("colsmol.ingest.b8", sample=16))).correct


def test_ingest_half_batch_is_caught(monkeypatch):
    from visual_rag_tpu_torch.models.embedder import VisualEmbedder

    real = VisualEmbedder.embed_images

    def half(self, images, *a, **kw):
        embs, infos = real(self, images[: len(images) // 2], *a, **kw)
        return embs + embs, infos + infos  # the rest get the first half's vectors

    monkeypatch.setattr(VisualEmbedder, "embed_images", half)
    assert not tiny.run(_f32(tiny.cell("colsmol.ingest.b8", sample=16))).correct
