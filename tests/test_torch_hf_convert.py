"""HuggingFace conversion and the small leftovers against the JAX package.

Tiny ``transformers`` models (random weights, built from local configs;
nothing is downloaded) convert through the port's ``convert_hf_model`` into
the tree that ``params_from_jax`` makes of the JAX package's conversion,
leaf for leaf and exactly, with the same ``EncoderArch``; the port's
forward then matches HF's ``last_hidden_state`` on valid rows and
``pooler_output`` at the reference's atol 2e-4, rtol 2e-3. ``from_hf`` +
``encode`` match the JAX package's ``from_hf`` within 1e-5 (f32) and HF's
own mean pool at the reference's atol 5e-4, rtol 1e-2. Then
``pad_to_bucket``, ``num_params``, ``bert_pooler`` (f32 within 1e-6; bf16
within one bf16 step), ``JsonlRunLog`` and ``embed_token_stack`` (within
1e-5 of the JAX package's, equal to ``embed_tokens`` batch by batch)."""

import json

import numpy as np
import pytest
import torch
import transformers

import jax
import jax.numpy as jnp

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.batching import pad_to_bucket as jax_pad_to_bucket
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models import num_params as jax_num_params
from text_similarity_tpu.models.hf_convert import arch_from_hf_config as jax_arch_from_hf
from text_similarity_tpu.models.hf_convert import convert_hf_model as jax_convert
from text_similarity_tpu.models.pooling import bert_pooler as jax_bert_pooler
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.utils.logging import JsonlRunLog as JaxRunLog
from text_similarity_tpu_torch.compress.quantize import quantize_params_int8
from text_similarity_tpu_torch.core.config import ARCH_PRESETS
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data import pad_to_bucket
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.models import (
    SentenceEncoder, arch_from_hf_config, convert_hf_model, convert_state_dict, encoder_forward,
    init_params, num_params, params_from_jax,
)
from text_similarity_tpu_torch.models.pooling import bert_pooler
from text_similarity_tpu_torch.utils import JsonlRunLog
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

HF_ATOL, HF_RTOL = 2e-4, 2e-3


def _bert():
    return transformers.BertModel(transformers.BertConfig(
        vocab_size=512, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
        intermediate_size=128, max_position_embeddings=96, type_vocab_size=2))


def _roberta():
    return transformers.RobertaModel(transformers.RobertaConfig(
        vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, max_position_embeddings=98, type_vocab_size=1, pad_token_id=1),
        add_pooling_layer=False)


def _distilbert():
    return transformers.DistilBertModel(transformers.DistilBertConfig(
        vocab_size=512, dim=64, n_layers=2, n_heads=4, hidden_dim=128,
        max_position_embeddings=96))


def _albert():
    return transformers.AlbertModel(transformers.AlbertConfig(
        vocab_size=512, embedding_size=32, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=128, max_position_embeddings=96,
        type_vocab_size=2))


FAMILIES = {"bert": _bert, "roberta": _roberta, "distilbert": _distilbert, "albert": _albert}


@pytest.fixture(scope="module")
def models():
    out = {}
    for seed, (name, make) in enumerate(FAMILIES.items()):
        torch.manual_seed(seed)
        out[name] = make().eval()
    return out


def _np(tree):
    return jax.tree.map(np.array, jax.device_get(tree))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _batch(vocab, b=3, s=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (b, s)).astype(np.int32)
    mask = (np.arange(s)[None] < np.array([s, 16, 9])[:b, None]).astype(np.int32)
    return ids * mask, mask


@pytest.mark.parametrize("family", list(FAMILIES))
def test_convert_hf_model_equals_the_jax_conversion(models, family):
    """The port's tree is params_from_jax of the JAX package's conversion,
    leaf for leaf and bit for bit, with the same arch (an ALBERT stack of
    depth 1; RoBERTa without a pooler, DistilBERT without token types)."""
    params, arch = convert_hf_model(models[family])
    jparams, jarch = jax_convert(models[family])
    assert arch.to_json() == jarch.to_json()
    want = _flat(params_from_jax(_np(jparams), arch))
    got = _flat(params)
    assert got.keys() == want.keys()
    for key, leaf in got.items():
        assert leaf.dtype == torch.float32 and leaf.is_contiguous(), key
        assert torch.equal(leaf, want[key]), key
    assert ("pooler/w" in got) == (family in ("bert", "albert"))
    assert ("embeddings/token_type" in got) == (family != "distilbert")
    if family == "albert":
        assert got["layers/attn/q/w"].shape[0] == 1 and got["embeddings/proj/w"].shape == (32, 64)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converted_forward_matches_hf(models, family):
    model = models[family]
    params, arch = convert_hf_model(model)
    ids, mask = _batch(model.config.vocab_size, seed=len(family))
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask).long())
        out = encoder_forward(params, torch.from_numpy(ids), torch.from_numpy(mask), arch=arch,
                              precision=FP32_PRECISION)
    m = mask.astype(bool)
    np.testing.assert_allclose(out.last_hidden_state.numpy()[m], ref.last_hidden_state.numpy()[m],
                               atol=HF_ATOL, rtol=HF_RTOL)
    if arch.has_pooler:
        np.testing.assert_allclose(out.pooler_output.numpy(), ref.pooler_output.numpy(),
                                   atol=HF_ATOL, rtol=HF_RTOL)
    else:
        assert out.pooler_output is None


def test_convert_state_dict_takes_numpy_and_strips_the_prefix(models):
    """An offline state dict of numpy arrays under the ``bert.`` prefix (a
    task model's keys) converts to the live model's tree, on the device
    asked for."""
    model = models["bert"]
    sd = {"bert." + k: v.numpy().copy() for k, v in model.state_dict().items()}
    arch = arch_from_hf_config(model.config)
    got = _flat(convert_state_dict(sd, arch, family="bert", device="cpu"))
    want = _flat(convert_hf_model(model)[0])
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)


@pytest.mark.parametrize("config", [
    lambda: transformers.BertConfig(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                                    num_attention_heads=2, intermediate_size=64),
    lambda: transformers.RobertaConfig(vocab_size=100, type_vocab_size=1, pad_token_id=1),
    lambda: transformers.XLMRobertaConfig(vocab_size=100, type_vocab_size=1, pad_token_id=1),
    lambda: transformers.CamembertConfig(vocab_size=100, type_vocab_size=1, pad_token_id=1),
    lambda: transformers.DistilBertConfig(vocab_size=100, activation="gelu"),
    lambda: transformers.AlbertConfig(vocab_size=100, embedding_size=16, hidden_size=32,
                                      num_attention_heads=2, intermediate_size=64),
], ids=["bert", "roberta", "xlm-roberta", "camembert", "distilbert", "albert"])
def test_arch_from_hf_config_matches_jax(config):
    cfg = config()
    assert arch_from_hf_config(cfg).to_json() == jax_arch_from_hf(cfg).to_json()


@pytest.mark.parametrize("config,match", [
    (lambda: transformers.AlbertConfig(vocab_size=100, num_hidden_groups=2), "single-group"),
    (lambda: transformers.AlbertConfig(vocab_size=100, inner_group_num=2), "single-group"),
    (lambda: transformers.GPT2Config(vocab_size=100), "unsupported model_type 'gpt2'"),
])
def test_arch_from_hf_config_refuses_what_the_reference_refuses(config, match):
    cfg = config()
    with pytest.raises(ValueError, match=match):
        jax_arch_from_hf(cfg)
    with pytest.raises(ValueError, match=match):
        arch_from_hf_config(cfg)


def test_from_hf_encodes_as_jax_and_as_hf():
    """SentenceEncoder.from_hf + encode: the JAX package's from_hf within
    1e-5, HF's own masked mean pool at the reference's tolerance."""
    corpus = ["a quick brown fox", "machine learning is fun", "fox learning"]
    vocab = train_wordpiece_vocab(corpus, 512, min_freq=1)
    tok = WordPieceTokenizer(vocab)
    cfg = transformers.BertConfig(vocab_size=tok.vocab_size, hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=64,
                                  max_position_embeddings=64)
    torch.manual_seed(0)
    model = transformers.BertModel(cfg).eval()
    enc = SentenceEncoder.from_hf(model, tokenizer=tok, precision=FP32_PRECISION, device="cpu")
    jenc = JaxSentenceEncoder.from_hf(model, tokenizer=JaxTokenizer(vocab), precision=JAX_FP32)
    emb = enc.encode(corpus)
    assert emb.shape == (3, 32) and enc.device.type == "cpu"
    np.testing.assert_allclose(emb, np.asarray(jenc.encode(corpus)), atol=1e-5)
    ids, mask = tok.encode_batch(corpus, max_len=16)
    with torch.no_grad():
        out = model(input_ids=torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask).long()).last_hidden_state.numpy()
    m = mask[..., None].astype(np.float32)
    pooled = (out * m).sum(1) / np.maximum(m.sum(1), 1e-9)
    pooled /= np.linalg.norm(pooled, axis=1, keepdims=True)
    np.testing.assert_allclose(enc.embed_tokens(ids, mask).numpy(), pooled, atol=5e-4, rtol=1e-2)


# ---------------------------------------------------------------------------
# The small leftovers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [20, 32, 100])
def test_pad_to_bucket_matches_jax(length):
    rng = np.random.default_rng(length)
    ids = rng.integers(1, 99, (3, length)).astype(np.int32)
    mask = np.ones((3, length), np.int32)
    got, want = pad_to_bucket(ids, mask), jax_pad_to_bucket(ids, mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype and g.shape[1] in (32, 128)


def test_num_params_matches_jax():
    """Every leaf's elements, dense and int8 ({q, s}) trees alike."""
    for name in ("tiny-test", "albert-base"):
        arch = ARCH_PRESETS[name]
        tree = init_params(arch, torch.Generator().manual_seed(0))
        want = jax_num_params(jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0),
                                                              JAX_PRESETS[name])))
        assert num_params(tree) == want
    q = quantize_params_int8(init_params(ARCH_PRESETS["tiny-test"]))
    assert num_params(q) == jax_num_params(_np_tree(q))


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_pooler_matches_jax(dtype):
    """tanh in f32, cast back to the hidden dtype: f32 within 1e-6, bf16
    within one bf16 step of a unit value (2^-8)."""
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((4, 7, 16)).astype(np.float32)
    w = (0.3 * rng.standard_normal((16, 16))).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    th = torch.from_numpy(hidden).to(getattr(torch, dtype))
    got = bert_pooler(th, torch.from_numpy(w), torch.from_numpy(b))
    want = jax_bert_pooler(jnp.asarray(hidden, getattr(jnp, dtype)), jnp.asarray(w), jnp.asarray(b))
    assert got.dtype == th.dtype and got.shape == (4, 16)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-6 if dtype == "float32" else 2.0 ** -8)


def test_jsonl_run_log_matches_jax(tmp_path):
    """The same records, a JSON object a line, appended across two opens."""
    for cls, name in ((JsonlRunLog, "port.jsonl"), (JaxRunLog, "jax.jsonl")):
        for _ in range(2):
            log = cls(str(tmp_path / name))
            log.log("step", loss=0.5, n=3)
            log.log("eval", metrics={"spearman": 0.8})
            log.close()
    port, ref = ([json.loads(line) for line in (tmp_path / n).read_text().splitlines()]
                 for n in ("port.jsonl", "jax.jsonl"))
    assert len(port) == 4
    assert [{k: v for k, v in r.items() if k != "ts"} for r in port] == \
        [{k: v for k, v in r.items() if k != "ts"} for r in ref]
    assert all(isinstance(r["ts"], float) for r in port)


def test_embed_token_stack_matches_jax_and_embed_tokens(tmp_path):
    """(n, B, L) → (n, B, D): within 1e-5 of the JAX package's (which
    chunks by STACK with a padded tail), each batch equal to embed_tokens."""
    corpus = [f"w{i} w{i * 3 % 17} w{i % 5}" for i in range(40)]
    vocab = train_wordpiece_vocab(corpus, 200, min_freq=1)
    jarch = JAX_PRESETS["tiny-test"].replace(vocab_size=len(vocab))
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(4), jarch), jarch,
                              tokenizer=JaxTokenizer(vocab), precision=JAX_FP32)
    jenc.save(str(tmp_path / "enc"))
    enc = SentenceEncoder.load(str(tmp_path / "enc"), bf16=False, device="cpu")
    ids, mask = enc.tokenizer.encode_batch(corpus[:36], max_len=16)
    ids, mask = ids.reshape(3, 12, -1), mask.reshape(3, 12, -1)
    got = enc.embed_token_stack(ids, mask)
    assert got.shape == (3, 12, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jenc.embed_token_stack(ids, mask)),
                               atol=1e-5)
    for i in range(3):
        assert torch.equal(got[i], enc.embed_tokens(ids[i], mask[i]))
    assert enc.embed_token_stack(ids[:0], mask[:0]).shape == (0, 12, 64)
