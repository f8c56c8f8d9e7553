"""The port's export bundle (``torch.export`` programs + int8 params) on
the CPU at b 2 × s 16, beside the JAX package's StableHLO bundle of the
same tiny-test encoder: the manifest's keys, the reloaded program against
the eager int8 encoder, the params read by the JAX package's
``restore_checkpoint_raw`` and the JAX bundle's params loaded by the port,
and the ``export`` command."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.compress.export import export_encoder_stablehlo
from text_similarity_tpu.compress.export import load_exported_fn as jax_load_fn
from text_similarity_tpu.core import checkpoint as jax_ckpt
from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu_torch.cli.main import main
from text_similarity_tpu_torch.compress.export import load_exported_fn, load_exported_params
from text_similarity_tpu_torch.core import checkpoint as ckpt
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.models import SentenceEncoder, params_from_jax
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, p))
        else:
            out[p] = v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _batch(vocab_size):
    rng = np.random.default_rng(0)
    ids = rng.integers(5, vocab_size, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    return ids * mask, mask


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """A JAX-initialised tiny-test encoder saved by the JAX package, its
    StableHLO bundle, and the port's bundle of the same saved encoder,
    written by the ``export`` command (its printed line kept)."""
    root = tmp_path_factory.mktemp("export")
    tok = WordPieceTokenizer(train_wordpiece_vocab(["alpha beta gamma delta epsilon"] * 3, 64,
                                                   min_freq=1))
    jarch = JAX_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size)
    jenc = JaxSentenceEncoder(jax_init(jax.random.PRNGKey(0), jarch), jarch, tokenizer=tok,
                              precision=JAX_FP32)
    model, jdir, tdir = (str(root / n) for n in ("model", "jax_bundle", "port_bundle"))
    jenc.save(model)
    jmanifest = export_encoder_stablehlo(jenc, jdir, batch_sizes=(2,), seq_lens=(16,))
    enc = SentenceEncoder.load(model, bf16=False, device="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["export", "--model", model, "--batch-sizes", "2", "--seq-lens", "16", "--fp32",
              "--save-path", tdir, "--device", "cpu"])
    with open(os.path.join(tdir, "manifest.json")) as fh:
        manifest = json.load(fh)
    return dict(model=model, jdir=jdir, tdir=tdir, enc=enc, manifest=manifest,
                jmanifest=jmanifest, tok=tok, printed=out.getvalue().strip().splitlines()[-1])


def test_manifest_has_the_reference_keys(bundles):
    m, jm = bundles["manifest"], bundles["jmanifest"]
    assert set(m) == set(jm) == {"arch", "pooling", "int8", "functions"}
    assert (m["arch"], m["pooling"], m["int8"]) == (jm["arch"], jm["pooling"], jm["int8"])
    (f,), (jf,) = m["functions"], jm["functions"]
    assert set(f) == set(jf)
    assert (f["name"], f["batch"], f["seq"], f["platforms"]) == ("encode_b2_s16.pt2", 2, 16,
                                                                 ["cpu"])
    assert f["bytes"] == os.path.getsize(os.path.join(bundles["tdir"], f["name"]))
    for name in ("arch.json", "vocab.txt"):
        assert os.path.exists(os.path.join(bundles["tdir"], name))


def test_reloaded_program_equals_the_eager_int8_encoder(bundles):
    """The program and params as a server loads them, against the same
    saved encoder after ``to_int8`` run eagerly: max |Δ| ≤ 1e-5 (the same
    ops on the same params)."""
    fn = load_exported_fn(bundles["tdir"], "encode_b2_s16.pt2")
    params = load_exported_params(bundles["tdir"], device="cpu")
    assert set(params["layers"]["attn"]["q"]["w"]) == {"q", "s"}
    ids, mask = _batch(bundles["enc"].arch.vocab_size)
    got = fn(params, torch.from_numpy(ids), torch.from_numpy(mask))
    eager = SentenceEncoder.load(bundles["model"], bf16=False, device="cpu").to_int8()
    want = eager.embed_tokens(ids, mask)
    assert got.shape == (2, 64) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5


def test_the_jax_package_reads_the_port_bundle(bundles):
    """``restore_checkpoint_raw`` of the JAX package reads the port
    bundle's params leaf for leaf (int8 codes and f32 scales equal to the
    JAX bundle's: both quantize the same weights), and the JAX package's
    exported program runs on them: cosine ≥ 0.9999 with the port's program
    (the two frameworks' dynamic activation quant may round a code the
    other way)."""
    tree, _, meta = jax_ckpt.restore_checkpoint_raw(jax_ckpt.latest_checkpoint(bundles["tdir"]))
    jtree, _, jmeta = jax_ckpt.restore_checkpoint_raw(jax_ckpt.latest_checkpoint(bundles["jdir"]))
    assert meta == jmeta == {"int8": True}
    got, want = _flat(tree), _flat(jtree)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k], w, rtol=1e-7, atol=0, err_msg=k)
    ids, mask = _batch(bundles["enc"].arch.vocab_size)
    jfn = jax_load_fn(bundles["jdir"], bundles["jmanifest"]["functions"][0]["name"])
    jout = np.asarray(jfn(jax.tree.map(jnp.asarray, tree), jnp.asarray(ids), jnp.asarray(mask)))
    fn = load_exported_fn(bundles["tdir"], "encode_b2_s16.pt2")
    tout = fn(load_exported_params(bundles["tdir"], device="cpu"), torch.from_numpy(ids),
              torch.from_numpy(mask)).numpy()
    assert (tout * jout).sum(axis=1).min() >= 0.9999


def test_the_port_loads_the_jax_bundle_params(bundles):
    """The JAX bundle's int8 tree through ``params_from_jax`` runs the
    port's program as its own params do."""
    jtree, _, _ = ckpt.restore_checkpoint_raw(ckpt.latest_checkpoint(bundles["jdir"]))
    params = params_from_jax(jtree, bundles["enc"].arch)
    own = load_exported_params(bundles["tdir"], device="cpu")
    fn = load_exported_fn(bundles["tdir"], "encode_b2_s16.pt2")
    ids, mask = (torch.from_numpy(a) for a in _batch(bundles["enc"].arch.vocab_size))
    assert float((fn(params, ids, mask) - fn(own, ids, mask)).abs().max()) <= 1e-6


def test_export_command(bundles):
    """The command prints the manifest's functions, and its bundle holds the
    int8 params it was traced on (``int8`` in the manifest and the
    checkpoint's meta)."""
    assert json.loads(bundles["printed"]) == bundles["manifest"]["functions"]
    _, _, meta = ckpt.restore_checkpoint_raw(ckpt.latest_checkpoint(bundles["tdir"]))
    assert bundles["manifest"]["int8"] is True and meta == {"int8": True}


@pytest.mark.parametrize("seq_lens", [(4096,), (128, 8192)])
def test_export_refuses_lengths_where_the_card_runs_k5(tmp_path, seq_lens):
    """An encoder on the card whose eager path would run K5 at a requested
    length (S % 128 == 0, S ≥ 4096) is refused before anything is written:
    the program could carry only the plain attention. The check reads the
    device alone, so an encoder that names the card stands in here."""
    from types import SimpleNamespace

    from text_similarity_tpu_torch.compress.export import export_encoder

    on_card = SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match=r"K5"):
        export_encoder(on_card, str(tmp_path / "bundle"), batch_sizes=(1,), seq_lens=seq_lens)
    assert not (tmp_path / "bundle").exists()
