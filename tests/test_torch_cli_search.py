"""The port's ``quantize``, ``encode``, ``search``, ``mine`` and
``compare-models`` through ``main([..., "--device", "cpu"])`` against the
JAX CLI's ``main`` on one JAX-saved tiny-test model: ``encode``'s ``.npy``
within 1e-5 in f32 (``--fp32``, bucketed by the auto rule and
``--packed``) and within BF16_TOL with bf16 compute; ``quantize``'s codes,
scales and meta bit for bit, its output loading in both packages;
``search --query`` and the interactive loop (piped stdin, EOF or an empty
line ends it) print the JAX CLI's lines; ``mine`` (exact, and ``--ivf
auto`` below 100k documents) prints its lines; ``compare-models`` its
JSON. Scores print at 4 decimals, where f32 differences of 1e-6 do not
show."""

import io
import json
import sys

import numpy as np
import pytest

import jax

from text_similarity_tpu.cli.main import main as jax_main
from text_similarity_tpu.core import checkpoint as jax_ckpt
from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from text_similarity_tpu.data.tokenization import train_wordpiece_vocab
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu_torch.cli.main import main
from text_similarity_tpu_torch.core import checkpoint as ckpt
from text_similarity_tpu_torch.models import SentenceEncoder
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# bf16 compute (the CLI's default without --fp32): activations round to bf16
# in both packages, in different orders, and unit-norm embeddings differ by
# about a bf16 step of their largest components (2^-8 · 0.44 = 1.7e-3).
# Readings of this recipe (corpus and init seeds 0-5, `_corpus(300, seed)`,
# `PRNGKey(seed)`): max |Δ| 2.84e-3 to 3.21e-3 (2.94e-3 at seed 0, the test's).
# Control, the same port encode with every weight matrix rounded to fp8 e4m3
# (3 mantissa bits against bf16's 7): 1.34e-2 to 2.36e-2 against the JAX
# package. The limit lies between the two, near their geometric mean (6.6e-3).
# (test_to_bf16_matches_jax's 2e-3 holds f32 compute over bf16 weights, where
# no activation rounds.)
BF16_TOL = 6.5e-3


def _corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"{chr(97 + i % 26)}{chr(97 + i * 5 % 26)}{i}" for i in range(400)]
    out, seen = [], set()
    while len(out) < n:
        s = " ".join(rng.choice(words, rng.integers(3, 14)))
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


CORPUS = _corpus(300)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX tiny-test encoder saved with its vocab, and the corpus file."""
    root = tmp_path_factory.mktemp("cli_search")
    jtok = JaxTokenizer(train_wordpiece_vocab(CORPUS, vocab_size=800, min_freq=1))
    jarch = JAX_PRESETS["tiny-test"].replace(vocab_size=jtok.vocab_size)
    JaxSentenceEncoder(jax_init(jax.random.PRNGKey(0), jarch), jarch, tokenizer=jtok,
                       precision=JAX_FP32).save(str(root / "enc"))
    (root / "docs.txt").write_text("\n".join(CORPUS) + "\n\n")
    return root


def _both(capsys, argv):
    """(the port's stdout lines, the JAX CLI's) for one command line."""
    main(argv + ["--device", "cpu"])
    port = capsys.readouterr().out.splitlines()
    jax_main(argv)
    return port, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("flags,tol", [(["--fp32"], 1e-5), (["--fp32", "--packed"], 1e-5),
                                       ([], BF16_TOL)], ids=["fp32", "fp32-packed", "bf16"])
def test_encode_matches_jax(saved, capsys, flags, tol):
    args = ["encode", "--model", str(saved / "enc"), "--corpus", str(saved / "docs.txt")] + flags
    port, ref = _both(capsys, args + ["--out", str(saved / "port.npy")])
    jax_main(args + ["--out", str(saved / "jax.npy")])
    capsys.readouterr()
    got, want = np.load(saved / "port.npy"), np.load(saved / "jax.npy")
    assert got.dtype == np.float32 and got.shape == want.shape == (300, 64)
    np.testing.assert_allclose(got, want, atol=tol)
    assert port == [f"encoded 300 texts -> {saved / 'port.npy'} (300, 64)"]


def test_quantize_matches_jax_bit_for_bit(saved, capsys):
    """The same int8 codes and f32 scales, meta (format, pooling), arch and
    vocab; each package loads the other's output to the same embeddings
    (dequantized f32 weights: within 1e-5)."""
    enc = str(saved / "enc")
    main(["quantize", "--model", enc, "--save-path", str(saved / "q_port"), "--fp32",
          "--device", "cpu"])
    jax_main(["quantize", "--model", enc, "--save-path", str(saved / "q_jax"), "--fp32"])
    outs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert outs == [{"saved": str(saved / "q_port"), "format": "int8"},
                    {"saved": str(saved / "q_jax"), "format": "int8"}]
    got = ckpt.restore_checkpoint_raw(ckpt.latest_checkpoint(str(saved / "q_port")))
    want = jax_ckpt.restore_checkpoint_raw(jax_ckpt.latest_checkpoint(str(saved / "q_jax")))
    assert got[2] == want[2] == {"format": "int8", "pooling": "mean"}
    flat_g, flat_w = jax.tree.leaves_with_path(got[0]), jax.tree.leaves_with_path(want[0])
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert g.dtype == w.dtype and np.array_equal(g, w), path
    assert any(g.dtype == np.int8 for _, g in flat_g)
    for name in ("arch.json", "vocab.txt"):
        assert (saved / "q_port" / name).read_text() == (saved / "q_jax" / name).read_text()
    port_of_jax = SentenceEncoder.load(str(saved / "q_jax"), bf16=False, device="cpu")
    jax_of_port = JaxSentenceEncoder.load(str(saved / "q_port"), bf16=False)
    np.testing.assert_allclose(port_of_jax.encode(CORPUS[:20]),
                               np.asarray(jax_of_port.encode(CORPUS[:20])), atol=1e-5)


def test_search_query_matches_jax(saved, capsys):
    """A corpus line finds itself first (score 1.0000), and the lines equal
    the JAX CLI's (brute force below 100k documents)."""
    args = ["search", "--model", str(saved / "enc"), "--corpus", str(saved / "docs.txt"),
            "--query", CORPUS[17], "--top-k", "4", "--fp32"]
    port, ref = _both(capsys, args)
    assert port == ref and len(port) == 4
    assert port[0] == f"1.0000\t{CORPUS[17]}"


@pytest.mark.parametrize("stdin,n_queries", [(f"{CORPUS[3]}\n{CORPUS[9]}\n", 2),
                                             (f"{CORPUS[3]}\n\n{CORPUS[9]}\n", 1)],
                         ids=["eof", "empty-line"])
def test_interactive_search_on_piped_stdin(saved, capsys, monkeypatch, stdin, n_queries):
    """Without --query: a prompt a line until EOF or an empty line, each
    answered as the JAX CLI answers it."""
    args = ["search", "--model", str(saved / "enc"), "--corpus", str(saved / "docs.txt"),
            "--top-k", "2", "--fp32"]
    outs = []
    for run in (lambda: main(args + ["--device", "cpu"]), lambda: jax_main(args)):
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        run()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[0].startswith("interactive search — empty line to exit\n")
    assert outs[0].count("query> ") == n_queries + 1
    assert f"1.0000\t{CORPUS[3]}" in outs[0]


@pytest.mark.parametrize("ivf", ["off", "auto"])
def test_mine_matches_jax(saved, capsys, ivf):
    """Exact mining (``auto`` below 100k documents): the JAX CLI's lines,
    score, then the two documents, best first, at most --max-pairs."""
    args = ["mine", "--model", str(saved / "enc"), "--corpus", str(saved / "docs.txt"),
            "--ivf", ivf, "--top-k", "3", "--min-score", "0.9", "--max-pairs", "60", "--fp32"]
    port, ref = _both(capsys, args)
    assert port == ref and len(port) == 60
    assert all(len(line.split("\t")) == 3 for line in port)


def test_mine_ivf_on_prints_pairs(saved, capsys):
    """``--ivf on`` at 300 documents: the port's IVF route (its own build)
    prints at most --max-pairs pairs of distinct corpus lines, best first."""
    main(["mine", "--model", str(saved / "enc"), "--corpus", str(saved / "docs.txt"), "--ivf",
          "on", "--top-k", "3", "--min-score", "0.0", "--max-pairs", "50", "--fp32",
          "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 50
    scores = [float(line.split("\t")[0]) for line in lines]
    assert scores == sorted(scores, reverse=True)
    assert all(a != b and a in CORPUS and b in CORPUS
               for a, b in (line.split("\t")[1:] for line in lines))


def test_compare_models_matches_jax(saved, capsys):
    """The teacher against its int8 output (loaded dequantized: weight
    quantization only, as the reference) and against itself; a student
    without a tokenizer takes the teacher's."""
    enc = str(saved / "enc")
    q = saved / "q_tok"
    main(["quantize", "--model", enc, "--save-path", str(q), "--fp32", "--device", "cpu"])
    (q / "vocab.txt").unlink()
    capsys.readouterr()
    for student in (str(q), enc):
        port, ref = _both(capsys, ["compare-models", "--model", enc, "--student", student,
                                   "--corpus", str(saved / "docs.txt"), "--num-queries", "30",
                                   "--fp32"])
        assert json.loads(port[-1]) == json.loads(ref[-1])
    assert json.loads(port[-1]) == {"mean_topk_overlap": 1.0, "min_topk_overlap": 1.0, "k": 10}
