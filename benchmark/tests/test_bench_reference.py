"""The plain reference at the tiny test size on the CPU, held to the port
computed in f32: the WordPiece rows, the encoder's unit embeddings (full
attention, and the band with a global CLS), and the first steps of a
bi-encoder training run with dropout."""

import numpy as np
import pytest
import torch

from benchmark import gen, weights
from benchmark.reference import encoder as E
from benchmark.reference import train as R
from benchmark.tests.conftest import tiny_config


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_wordpiece_matches_the_port():
    from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer

    port = WordPieceTokenizer.from_vocab_file(gen.VOCAB)
    texts = gen.sentence_texts(30, 8, 40, gen.rng_for(1, 1)).all() + ["Qzx, kaba-lo! [x]"]
    ids, mask = gen.tokenizer().batch(texts, 32)
    p_ids, p_mask = port.encode_batch(texts, 32)
    assert np.array_equal(ids, p_ids) and np.array_equal(mask, p_mask)


@pytest.mark.parametrize("name", ["minilm-l6", "roberta-base-long"])
def test_encoder_matches_the_port_in_f32(name):
    from text_similarity_tpu_torch.core.config import EncoderArch
    from text_similarity_tpu_torch.core.precision import FP32_PRECISION
    from text_similarity_tpu_torch.models import encoder_forward
    from text_similarity_tpu_torch.models.pooling import mean_pool

    f = weights.arch_fields(tiny_config(name))
    texts, _ = gen.documents(3, 40, 90, gen.rng_for(2, 1))
    ids, mask = gen.tokenizer().batch(texts, 128)
    ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
    p = weights.make_params(f, 3, "cpu")
    ref = E.embed_rows(p, f, ids, mask)
    out = encoder_forward(p, ids, mask, arch=EncoderArch(**f), precision=FP32_PRECISION,
                          attention_impl="reference")
    got = E.normalize(mean_pool(out.last_hidden_state, mask))
    assert torch.allclose(got, ref, atol=2e-5), float((got - ref).abs().max())


def test_blocked_band_equals_the_dense_band():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 300, 8, generator=g) for _ in range(3))
    mask = torch.ones(2, 300, dtype=torch.int32)
    mask[1, 250:] = 0
    pos = torch.arange(300)
    band = ((pos[:, None] - pos[None, :]).abs() <= 20) | (pos[:, None] == 0) | (pos[None, :] == 0)
    keep = band[None, None] & mask.bool()[:, None, None, :]
    s = torch.where(keep, q @ k.transpose(-1, -2) / 8 ** 0.5, torch.tensor(-1e30))
    dense = torch.softmax(s, -1) @ v
    got = E.attention(q, k, v, mask, 20, True, block=64)
    assert torch.allclose(got[0], dense[0], atol=1e-5)
    assert torch.allclose(got[1, :, :250], dense[1, :, :250], atol=1e-5)


def test_training_steps_match_the_port_in_f32():
    """Three steps of the port's bi-encoder step (f32 compute, dropout on)
    against the reference's, from the same weights and generator seed."""
    from text_similarity_tpu_torch.core.config import EncoderArch, TrainConfig
    from text_similarity_tpu_torch.core.precision import FP32_PRECISION
    from text_similarity_tpu_torch.train import (
        init_train_state, make_bi_encoder_train_step, make_optimizer,
    )

    f = weights.arch_fields(tiny_config("roberta-base-long"))
    pairs, _ = gen.document_pairs(9, 50, 90, gen.rng_for(4, 1))
    batches = gen.pair_batches(pairs, 3, 128, 128)
    opt = {"lr": 1e-3, "total_steps": 10, "warmup_steps": 1, "adam_b1": 0.9, "adam_b2": 0.999,
           "adam_eps": 1e-8, "weight_decay": 0.01, "max_grad_norm": 1.0}
    flat0 = weights.make_flat(f, 5, "cpu")
    tx = make_optimizer(TrainConfig(lr=1e-3, warmup_ratio=0.1), 10,
                        params_example={"encoder": weights.nest(flat0)})
    state = init_train_state({"encoder": weights.nest(flat0)}, tx, seed=77, device="cpu")
    step = make_bi_encoder_train_step(EncoderArch(**f), tx, loss_type="mnrl",
                                      precision=FP32_PRECISION, device="cpu")
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    tb = [{k: torch.as_tensor(v) for k, v in b.items()} for b in batches]
    ref = R.follow(flat0, f, tb, 77, opt, 3)
    assert np.allclose(losses, ref["losses"], atol=1e-5)
    got = weights.flatten(state.params["encoder"])
    # a key's bias has no gradient under softmax but round-off, which Adam
    # scales up: leaves under a thousandth of the median leaf's gradient
    # are left out, as the check leaves them out
    norms = {p: float(g.norm()) for p, g in ref["grad1"].items()}
    med = float(np.median(list(norms.values())))
    left_out = [p for p, n in norms.items() if n < 1e-3 * med]
    assert left_out == ["layers/attn/k/b", "pooler/w", "pooler/b"]
    for p, d in ref["delta"].items():
        if p not in left_out:
            assert torch.allclose(got[p].detach() - flat0[p], d, atol=1e-6), p
