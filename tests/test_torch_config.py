"""The port's ``RunConfig`` and ``MeshConfig`` against the JAX package's:
a run JSON the JAX package wrote reads back field for field, and the
port's JSON reads in the JAX package."""

import dataclasses
import json

import pytest

from text_similarity_tpu.core import config as jax_config
from text_similarity_tpu_torch.core import config


def _run_configs():
    arch = dict(hidden_size=384, num_layers=6, num_heads=12, intermediate_size=1536)
    return [
        (jax_config.RunConfig(), config.RunConfig()),
        (jax_config.RunConfig(
            model_name="minilm-l6", arch=jax_config.ARCH_PRESETS["minilm-l6"].replace(**arch),
            mesh=jax_config.MeshConfig(data=2, model=2, index=2),
            train=jax_config.TrainConfig(lr=3e-4, batch_size=64, max_seq_len=128,
                                         metric_direction="min"),
            index=jax_config.IndexConfig.auto(1_000_000), save_path="runs/a"),
         config.RunConfig(
            model_name="minilm-l6", arch=config.ARCH_PRESETS["minilm-l6"].replace(**arch),
            mesh=config.MeshConfig(data=2, model=2, index=2),
            train=config.TrainConfig(lr=3e-4, batch_size=64, max_seq_len=128,
                                     metric_direction="min"),
            index=config.IndexConfig.auto(1_000_000), save_path="runs/a")),
    ]


@pytest.mark.parametrize("case", [0, 1])
def test_run_config_reads_the_jax_json(case):
    jcfg, want = _run_configs()[case]
    got = config.RunConfig.from_json(jcfg.to_json())
    assert got == want
    assert json.loads(got.to_json()) == json.loads(jcfg.to_json())


@pytest.mark.parametrize("case", [0, 1])
def test_jax_reads_the_run_config_json(case):
    jcfg, cfg = _run_configs()[case]
    assert jax_config.RunConfig.from_json(cfg.to_json()) == jcfg


def test_mesh_and_train_configs_have_the_reference_fields():
    for ours, theirs in ((config.MeshConfig, jax_config.MeshConfig),
                         (config.TrainConfig, jax_config.TrainConfig),
                         (config.RunConfig, jax_config.RunConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(ours)
                if f.default is not dataclasses.MISSING] == \
            [(f.name, f.default) for f in dataclasses.fields(theirs)
             if f.default is not dataclasses.MISSING]
    m = config.MeshConfig(data=2, model=4)
    assert m.num_devices == 8 and m.axis_names() == ("data", "model", "index")
