"""The port's export bundle (``torch.export`` programs + int8 params) on
the CPU at b 2 × s 16, beside the JAX package's StableHLO bundle of the
same tiny-test encoder: the manifest's keys, the reloaded program against
the eager int8 encoder, the params read by the JAX package's
``restore_checkpoint_raw`` and the JAX bundle's params loaded by the port,
and the ``export`` command; K5's registered op under ``torch.library``'s
checks, and a CPU export that the attention rule sends to flash, whose
graph holds the op."""

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
from text_similarity_tpu_torch.ops import attention as attn
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


@pytest.mark.parametrize("dtype,window,cls,lse", [
    (torch.float32, 0, False, True), (torch.float32, 8, True, False),
    (torch.bfloat16, 4, False, True),
])
def test_flash_fwd_op_passes_opcheck(dtype, window, cls, lse):
    """K5's registered op (its CPU implementation is the plain version):
    schema, fake tensor and AOT dispatch checks of ``torch.library``, and
    the op's answer equals ``flash_attention_plain``'s."""
    from text_similarity_tpu_torch.ops.attention import flash_attention_plain, flash_fwd_op

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 48, 2, 32), generator=g).to(dtype) for _ in range(3))
    lengths = torch.tensor([48, 30], dtype=torch.int32)
    args = (q, k, v, lengths, window, cls, lse)
    results = torch.library.opcheck(flash_fwd_op, args)
    assert set(results.values()) == {"SUCCESS"}, results
    out, got_lse = flash_fwd_op(*args)
    want, want_lse = flash_attention_plain(q, k, v, lengths, window, cls, return_lse=True)
    assert torch.equal(out, want)
    assert torch.equal(got_lse, want_lse) if lse else got_lse.shape == (0,)


@pytest.fixture(scope="module")
def flash_bundle(bundles, tmp_path_factory):
    """The tiny-test encoder exported on the CPU with the attention rule
    sending it to flash, as the card's rule does from 4,096 tokens (the
    plain K5 through its op), and its program."""
    from text_similarity_tpu_torch.compress.export import export_encoder

    path = str(tmp_path_factory.mktemp("flash_export"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attn, "auto_impl", lambda *a, **kw: "flash")
        manifest = export_encoder(bundles["enc"], path, batch_sizes=(2,), seq_lens=(16,))
    name = manifest["functions"][0]["name"]
    return path, name, torch.export.load(os.path.join(path, name))


def test_cpu_export_with_flash_carries_the_op(bundles, flash_bundle):
    """The traced graph holds K5's op, once a layer; reloaded, the program
    equals the eager int8 encode step on the flash path (max |Δ| ≤ 1e-5:
    the same ops) and the reference-attention program within 1e-5."""
    from text_similarity_tpu_torch.compress.export import _EncodeStep
    from text_similarity_tpu_torch.compress.quantize import quantize_params_int8

    path, name, program = flash_bundle
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert sum("text_similarity_tpu_torch.flash_fwd" in t for t in targets) == \
        bundles["enc"].arch.num_layers
    fn = load_exported_fn(path, name)
    params = load_exported_params(path, device="cpu")
    ids, mask = (torch.from_numpy(a) for a in _batch(bundles["enc"].arch.vocab_size))
    got = fn(params, ids, mask)
    enc = bundles["enc"]
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(attn, "auto_impl", lambda *a, **kw: "flash")
        want = _EncodeStep(enc.arch, enc.precision, enc.pooling)(
            quantize_params_int8(enc.params), ids, mask)
    assert float((got - want).abs().max()) <= 1e-5
    ref = load_exported_fn(bundles["tdir"], "encode_b2_s16.pt2")(params, ids, mask)
    assert float((got - ref).abs().max()) <= 1e-5


def test_the_jax_package_reads_the_flash_bundle_params(bundles, flash_bundle):
    """The flash bundle's params, read by the JAX package's
    ``restore_checkpoint_raw``, equal its own bundle's leaf for leaf."""
    path, _, _ = flash_bundle
    tree, _, meta = jax_ckpt.restore_checkpoint_raw(jax_ckpt.latest_checkpoint(path))
    jtree, _, _ = jax_ckpt.restore_checkpoint_raw(jax_ckpt.latest_checkpoint(bundles["jdir"]))
    assert meta == {"int8": True}
    got, want = _flat(tree), _flat(jtree)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-7, atol=0, err_msg=k)
