"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points default to the card without falling back to
the CPU."""

import functools
import os
import pathlib
import re
import subprocess
import sys
import types

import pytest
import torch

import text_similarity_tpu_torch
from text_similarity_tpu_torch.core.config import ARCH_PRESETS, IndexConfig
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.index import EmbeddingStore, IVFIndex
from text_similarity_tpu_torch.cli.main import build_parser, build_server
from text_similarity_tpu_torch.cli.main import main as cli_main
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.drives import churn, moe_router_skew, serve_load
from text_similarity_tpu_torch.models import SentenceEncoder, arch_from_hf_config, init_params
from text_similarity_tpu_torch.models.encoder import _param_shapes
from text_similarity_tpu_torch.models.hf_convert import _BERT_LAYER, _EMB
from text_similarity_tpu_torch.models.cross_encoder import CrossEncoder
from text_similarity_tpu_torch.pipelines import (
    SemanticSearchPipeline, SentenceMiningPipeline, compare_models,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(text_similarity_tpu_torch.__file__).resolve().parent

def _module_name(path: pathlib.Path) -> str:
    parts = path.relative_to(PKG).with_suffix("").parts
    if parts[-1] == "__init__":     # a package: native/ holds its code there
        parts = parts[:-1]
    return ".".join(("text_similarity_tpu_torch",) + parts)


MODULES = sorted(_module_name(p) for p in PKG.rglob("*.py"))

# a meta-path finder that refuses jax and the exact top-level JAX package
# (text_similarity_tpu_torch shares its prefix, so match whole names), and
# transformers, which the card's machine lacks (models.hf_convert reads a
# live model's config and state dict without it)
_BLOCKER = """
import sys
BLOCKED = ("jax", "jaxlib", "text_similarity_tpu", "transformers")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import importlib
for m in sys.argv[1:]:
    importlib.import_module(m)
assert not any(k.split(".")[0] in BLOCKED for k in sys.modules), sorted(sys.modules)
print("ok")
"""


def test_port_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKER, *MODULES],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert len(MODULES) >= 15
    assert {"text_similarity_tpu_torch." + m for m in (
        "native", "models.cross_encoder", "pipelines.rerank", "pipelines.serve", "cli.main",
        "cli.__main__", "__main__", "utils.logging", "data.datasets", "data.pairs",
        "evaluation", "evaluation.meters", "evaluation.evaluators", "train.steps",
        "drives.churn", "drives.serve_load", "train.hpo", "models.hf_convert",
        "compress.distill", "compress.theseus", "compress.prune", "compress.export", "ops.pca",
        "ops.density", "ops.segment", "pipelines.clustering", "pipelines.topic",
        "models.word_encoder", "utils.lexicon", "utils.senses", "utils.profiling",
        "ops.performer", "ops.moe", "drives.moe_router_skew", "core.mesh", "index.sharded",
        "ops.ring_attention", "ops.ulysses", "models.long_context", "models.pipeline",
        "models.sharded", "dryrun",
    )} <= set(MODULES)


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|text_similarity_tpu)\b(?!_)", re.M
)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_has_no_jax_import(path):
    src = (REPO / path).read_text()
    assert not _FORBIDDEN.search(src), path


def _tiny_tokenizer():
    return WordPieceTokenizer(train_wordpiece_vocab(["alpha beta", "beta gamma"], 64,
                                                    min_freq=1))


class _TinyHF:
    """What the conversion reads of a live HF BERT: ``.config`` and
    ``.state_dict()`` (zeros of a one-layer, 8-wide model's shapes)."""

    config = types.SimpleNamespace(
        model_type="bert", vocab_size=32, hidden_size=8, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=16, max_position_embeddings=16,
        type_vocab_size=2, layer_norm_eps=1e-12, hidden_act="gelu", pad_token_id=0)

    def state_dict(self):
        shapes = _param_shapes(arch_from_hf_config(self.config))
        sd = {key.format(i=0): torch.zeros(functools.reduce(dict.get, path, shapes["layers"])
                                           [1:][::-1])       # one layer; (out, in) weights
              for path, key in _BERT_LAYER.items()}
        emb = dict(shapes["embeddings"], ln_scale=(8,), ln_bias=(8,))
        sd.update({key: torch.zeros(emb[name]) for name, key in _EMB["bert"].items()})
        sd["pooler.dense.weight"], sd["pooler.dense.bias"] = torch.zeros(8, 8), torch.zeros(8)
        return sd


def _tiny_encoder_args():
    arch = ARCH_PRESETS["tiny-test"]
    params = init_params(arch, torch.Generator().manual_seed(0))
    return params, arch


@pytest.mark.parametrize(
    "entry", ["encoder", "store", "ivf_build", "pipeline", "cross_encoder", "serve_cli",
              "from_hf", "mining_pipeline", "compare_models", "quantize_cli", "encode_cli",
              "search_cli", "mine_cli", "compare_models_cli", "churn_drive", "serve_load_drive",
              "export_cli", "cluster_cli", "topics_cli", "distill_cli", "word_encoder",
              "exported_params", "moe_router_skew_drive", "make_mesh", "dryrun"]
)
def test_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """Without device=..., every entry point asks for CUDA: it raises when no
    card is present and lands on the card when one is."""
    params, arch = _tiny_encoder_args()
    x = torch.nn.functional.normalize(torch.randn(256, arch.hidden_size), dim=1)

    def make():
        if entry == "encoder":
            return SentenceEncoder(params, arch, precision=FP32_PRECISION)
        if entry == "store":
            return EmbeddingStore(16, arch.hidden_size)
        if entry == "ivf_build":
            return IVFIndex.build(x, IndexConfig(num_clusters=4, kmeans_iters=1))
        if entry == "cross_encoder":
            return CrossEncoder.init(torch.Generator().manual_seed(0), arch,
                                     precision=FP32_PRECISION)
        if entry == "serve_cli":
            # the CLI's --device defaults to cuda
            SentenceEncoder(params, arch, precision=FP32_PRECISION, device="cpu").save(
                str(tmp_path / "enc"))
            server = build_server(build_parser().parse_args(
                ["serve", "--model", str(tmp_path / "enc"), "--port", "0"]))
            server.shutdown()
            return server
        if entry.endswith("_cli"):
            # the commands' --device defaults to cuda too
            SentenceEncoder(params, arch, tokenizer=_tiny_tokenizer(), precision=FP32_PRECISION,
                            device="cpu").save(str(tmp_path / "enc"))
            (tmp_path / "docs.txt").write_text("alpha beta\nbeta gamma\n")
            model, docs = str(tmp_path / "enc"), str(tmp_path / "docs.txt")
            argv = {
                "quantize_cli": ["quantize", "--save-path", str(tmp_path / "q")],
                "encode_cli": ["encode", "--corpus", docs, "--out", str(tmp_path / "e.npy")],
                "search_cli": ["search", "--corpus", docs, "--query", "alpha"],
                "mine_cli": ["mine", "--corpus", docs],
                "compare_models_cli": ["compare-models", "--corpus", docs, "--student", model],
                "export_cli": ["export", "--save-path", str(tmp_path / "x"), "--seq-lens", "8"],
                "cluster_cli": ["cluster", "--corpus", docs],
                "topics_cli": ["topics", "--corpus", docs],
                "distill_cli": ["distill", "--data", docs, "--save-path", str(tmp_path / "d")],
            }[entry]
            return cli_main(argv + ["--model", model])
        if entry == "word_encoder":
            from text_similarity_tpu_torch.models.word_encoder import WordEncoder

            return WordEncoder(params, arch)
        if entry == "exported_params":
            from text_similarity_tpu_torch.compress.export import load_exported_params
            from text_similarity_tpu_torch.core.checkpoint import save_checkpoint

            save_checkpoint(str(tmp_path / "bundle"), params, step=0, meta={"int8": False})
            return load_exported_params(str(tmp_path / "bundle"))
        if entry == "make_mesh":
            from text_similarity_tpu_torch.core.mesh import make_mesh

            return make_mesh()
        if entry == "dryrun":
            from text_similarity_tpu_torch.dryrun import dryrun_multichip

            return dryrun_multichip(2)
        if entry == "from_hf":
            return SentenceEncoder.from_hf(_TinyHF(), precision=FP32_PRECISION)
        if entry == "churn_drive":
            return churn.main(["--n", "500", "--d", "32", "--queries", "8"])
        if entry == "moe_router_skew_drive":
            for name, value in (("ARCH", "tiny-test"), ("TRAIN_SHAPE", (2, 16)),
                                ("EVAL_SHAPE", (2, 16)), ("EVAL_BATCHES", 1)):
                monkeypatch.setattr(moe_router_skew, name, value)
            return moe_router_skew.main(["--train", "--steps", "1", "--ckpt", str(tmp_path)])
        if entry == "serve_load_drive":
            return serve_load.main(["--n-docs", "50", "--arch", "tiny-test", "--phases", "A",
                                    "--duration", "0.1"])
        enc = SentenceEncoder(
            params, arch, precision=FP32_PRECISION,
            device="cuda" if torch.cuda.is_available() else "cpu",
        )
        if entry == "mining_pipeline":
            return SentenceMiningPipeline(enc)
        if entry == "compare_models":
            return compare_models(enc, enc, ["alpha beta", "beta gamma"], ["alpha"], k=1)
        return SemanticSearchPipeline(enc)

    if torch.cuda.is_available():
        obj = make()
        assert obj is not None
    else:
        with pytest.raises((RuntimeError, ValueError)):
            make()


def test_cpu_only_when_asked():
    params, arch = _tiny_encoder_args()
    enc = SentenceEncoder(params, arch, precision=FP32_PRECISION, device="cpu")
    assert enc.device.type == "cpu"
    assert next(enc.parameters()).device.type == "cpu"


def test_build_hash_covers_every_kernel_source():
    """Every ``*.cu`` under ``csrc/`` is compiled (``_cuda.SOURCES``) and
    every ``*.cuh`` is hashed (``_cuda.HEADERS``): a source or header the
    build hash missed would let an edited tree reuse a stale library."""
    from text_similarity_tpu_torch.ops import _cuda

    on_disk = {p.name for p in _cuda.CSRC.iterdir()}
    assert {n for n in on_disk if n.endswith(".cu")} == set(_cuda.SOURCES)
    assert {n for n in on_disk if n.endswith(".cuh")} == set(_cuda.HEADERS)


def test_ctypes_signatures_match_the_sources():
    """Every ``extern "C"`` entry point of ``csrc/`` has a ctypes signature
    in ``_cuda._SIGNATURES`` of the same arity and argument kinds (pointer,
    int, long long, float), and no signature names a missing entry: ctypes
    would otherwise pass a call's arguments shifted, unseen until the card
    runs it."""
    import ctypes
    import re

    from text_similarity_tpu_torch.ops import _cuda

    def kind(param: str):
        if "*" in param:
            return ctypes.c_void_p
        for prefix, t in (("long long", ctypes.c_longlong), ("float", ctypes.c_float),
                          ("int", ctypes.c_int)):
            if param.startswith(prefix):
                return t
        raise AssertionError(f"unknown parameter type: {param}")

    defs = {}
    for src in _cuda.SOURCES:
        text = (_cuda.CSRC / src).read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)\s*\{', text):
            defs[m.group(1)] = [kind(p.strip()) for p in m.group(2).split(",")]
    assert set(defs) == set(_cuda._SIGNATURES)
    for name, argtypes in _cuda._SIGNATURES.items():
        assert argtypes == defs[name], name
