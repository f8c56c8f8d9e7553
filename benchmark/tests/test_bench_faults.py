"""A whole run at the tiny test size with the timed path broken
underneath comes out not correct, once for each fault the cell can have:
an answer altered where it is produced, half of the batch left out, for
search half the probes scanned and a merge that keeps the wrong
candidates, and for training a step that returns its state unchanged and
a token altered.
The same run unbroken comes out correct under the same limits (the tiny
size's own, ``tiny_limits.json``)."""

import pytest
import torch

from benchmark.tests.tiny_run import run_tiny


def _sound(cell):
    rc, res, err = run_tiny(cell)
    assert rc == 0 and res["correct"] is True, err[-2000:]
    return res


def _broken(cell):
    rc, res, err = run_tiny(cell)
    assert rc == 0 and res["correct"] is False, res["checks"]
    return res


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _shift_ids(monkeypatch):
    from text_similarity_tpu_torch.index.ivf import IVFIndex

    inner = IVFIndex.query

    def query(self, q, *a, **kw):
        s, i = inner(self, q, *a, **kw)
        return s, torch.where(i >= 0, (i + 1) % self.ids_padded.max().clamp_min(1), i)

    monkeypatch.setattr(IVFIndex, "query", query)


def _half_rows(monkeypatch):
    from text_similarity_tpu_torch.index.ivf import IVFIndex

    inner = IVFIndex.query

    def query(self, q, *a, **kw):
        # the first half answered; the second given the first half's rows
        b, h = q.shape[0], max(q.shape[0] // 2, 1)
        s, i = inner(self, q[:h], *a, **kw)
        idx = torch.arange(b, device=s.device) % h
        return s[idx], i[idx]

    monkeypatch.setattr(IVFIndex, "query", query)


def _planted(monkeypatch, variant):
    from benchmark.cells import with_fault
    from text_similarity_tpu_torch.index.ivf import IVFIndex

    inner = IVFIndex.query

    def query(self, q, **kw):
        return with_fault(variant, lambda q2, **kw2: inner(self, q2, **kw2),
                          self.config.num_probes)(q, **kw)

    monkeypatch.setattr(IVFIndex, "query", query)


@pytest.mark.parametrize("cell", ["minilm-l6.search-text", "minilm-l6.search-vectors"])
def test_search_sound(cell):
    _sound(cell)


@pytest.mark.parametrize("cell", ["minilm-l6.search-text", "minilm-l6.search-vectors"])
def test_search_answer_altered(cell, monkeypatch):
    _shift_ids(monkeypatch)
    _broken(cell)


@pytest.mark.parametrize("cell", ["minilm-l6.search-text", "minilm-l6.search-vectors"])
def test_search_half_the_batch(cell, monkeypatch):
    _half_rows(monkeypatch)
    _broken(cell)


@pytest.mark.parametrize("variant", ["half_probes", "wrong_merge"])
@pytest.mark.parametrize("cell", ["minilm-l6.search-text", "minilm-l6.search-vectors"])
def test_search_selection_broken(cell, variant, monkeypatch):
    """Rows of the right form, scores true to their ids, the wrong ids:
    only the selection check sees it."""
    _planted(monkeypatch, variant)
    res = _broken(cell)
    failed = [n for n, c in res["checks"].items() if c["value"] > c["limit"]]
    assert "sel_miss" in failed and "scan_gap" not in failed and "bad_rows" not in failed


def test_encode_sound():
    _sound("roberta-base-long.encode")


def test_encode_answer_altered(monkeypatch):
    from text_similarity_tpu_torch.models import SentenceEncoder

    inner = SentenceEncoder.encode
    monkeypatch.setattr(SentenceEncoder, "encode",
                        lambda self, *a, **kw: torch.roll(inner(self, *a, **kw), 1, dims=0))
    _broken("roberta-base-long.encode")


def test_encode_half_the_batch(monkeypatch):
    from text_similarity_tpu_torch.models import SentenceEncoder

    inner = SentenceEncoder.encode

    def encode(self, texts, *a, **kw):
        h = len(texts) // 2
        e = inner(self, texts[:h], *a, **kw)
        return torch.cat([e, e.mean(0, keepdim=True).expand(len(texts) - h, -1)])

    monkeypatch.setattr(SentenceEncoder, "encode", encode)
    _broken("roberta-base-long.encode")


def test_train_sound():
    _sound("roberta-base-long.train")


def test_train_state_unchanged(monkeypatch):
    from text_similarity_tpu_torch.train.optim import AdamW

    monkeypatch.setattr(AdamW, "step", lambda self, params, grads, state: True)
    res = _broken("roberta-base-long.train")
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch(monkeypatch):
    from text_similarity_tpu_torch.train import steps

    inner = steps.bi_encoder_loss

    def loss(params, batch, **kw):
        h = batch["ids_a"].shape[0] // 2
        return inner(params, {k: v[:h] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(steps, "bi_encoder_loss", loss)
    _broken("roberta-base-long.train")


def test_train_token_altered(monkeypatch):
    from text_similarity_tpu_torch.train import steps

    inner = steps.bi_encoder_loss

    def loss(params, batch, **kw):
        ids = batch["ids_a"].clone()
        ids[:, 1] = (ids[:, 1] + 1) % 30522
        return inner(params, {**batch, "ids_a": ids}, **kw)

    monkeypatch.setattr(steps, "bi_encoder_loss", loss)
    _broken("roberta-base-long.train")
