"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points default to the card without falling back to
the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import text_similarity_tpu_torch
from text_similarity_tpu_torch.core.config import ARCH_PRESETS, IndexConfig
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.index import EmbeddingStore, IVFIndex
from text_similarity_tpu_torch.models import SentenceEncoder, init_params
from text_similarity_tpu_torch.pipelines import SemanticSearchPipeline

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(text_similarity_tpu_torch.__file__).resolve().parent

MODULES = sorted(
    "text_similarity_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py")
    if p.name != "__init__.py"
)

# a meta-path finder that refuses jax and the exact top-level JAX package
# (text_similarity_tpu_torch shares its prefix, so match whole names)
_BLOCKER = """
import sys
BLOCKED = ("jax", "jaxlib", "text_similarity_tpu")
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


def _tiny_encoder_args():
    arch = ARCH_PRESETS["tiny-test"]
    params = init_params(arch, torch.Generator().manual_seed(0))
    return params, arch


@pytest.mark.parametrize("entry", ["encoder", "store", "ivf_build", "pipeline"])
def test_entry_points_default_to_the_card(entry):
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
        enc = SentenceEncoder(
            params, arch, precision=FP32_PRECISION,
            device="cuda" if torch.cuda.is_available() else "cpu",
        )
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
