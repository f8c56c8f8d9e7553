"""Pipeline parallelism (``models.pipeline.encoder_forward_pp`` and the steps'
``pp_mesh``) against the plain forward and the JAX package's pipelined
forward and step on its 8 virtual CPU devices, mirroring
``tests/test_pipeline_parallel.py``: the forward, DP × PP, microbatch
counts, gradients, remat, the bi-encoder, classifier and MLM steps, dropout
and the refusals; and ``train-sts --pipe 2`` on CPU positions. The port's
positions are the one CPU repeated. Tiny-test arch (4 layers), f32, dropout
0 where results are compared; inputs from numpy seeds."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.config import TrainConfig as JaxTrainConfig
from text_similarity_tpu.core.mesh import make_mesh as jax_make_mesh
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.models import encoder_forward_pp as jax_forward_pp
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.train import init_train_state as jax_init_train_state
from text_similarity_tpu.train import make_bi_encoder_train_step as jax_bi_step
from text_similarity_tpu.train import make_optimizer as jax_make_optimizer
from text_similarity_tpu_torch.cli.main import main as cli_main
from text_similarity_tpu_torch.core.config import ARCH_PRESETS, TrainConfig
from text_similarity_tpu_torch.core.mesh import make_mesh
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.models import (
    encoder_forward, encoder_forward_pp, init_params, mean_pool, params_from_jax,
)
from text_similarity_tpu_torch.train import (
    init_classifier_head, init_train_state, make_bi_encoder_train_step,
    make_classifier_train_step, make_mlm_train_step, make_optimizer,
)
from text_similarity_tpu_torch.train.steps import bi_encoder_loss, classifier_forward
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

NO_DROP = dict(hidden_dropout=0.0, attention_dropout=0.0)


def _mesh(**kw):
    n = int(np.prod(list(kw.values())))
    return make_mesh(**kw, devices=["cpu"] * n)


def _arch(layers=4, **kw):
    return ARCH_PRESETS["tiny-test"].replace(num_layers=layers, **{**NO_DROP, **kw})


def _params(arch, seed=0):
    return init_params(arch, torch.Generator().manual_seed(seed))


def _batch(arch, b=8, s=16, seed=0, ragged=True):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, arch.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    if ragged:   # each microbatch carries its own mask through the ticks
        for r in range(b):
            mask[r, s - 1 - (r % 4):] = 0
    return torch.from_numpy(ids), torch.from_numpy(mask)


def _plain(params, ids, mask, arch):
    return encoder_forward(params, ids, mask, arch=arch, precision=FP32_PRECISION).last_hidden_state


def _pp(params, ids, mask, arch, mesh, **kw):
    return encoder_forward_pp(params, ids, mask, arch=arch, mesh=mesh, precision=FP32_PRECISION,
                              **kw)


def _trainable(tree):
    return {k: _trainable(v) if isinstance(v, dict) else v.clone().requires_grad_(True)
            for k, v in tree.items()}


def _stack_leaves(params):
    """The leaves the layer stack's forward reaches (not the pooler)."""
    return _leaves({k: params[k] for k in ("embeddings", "layers")})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, p))
        else:
            out[p] = v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _leaves(tree):
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _pair_batch(arch, b=8, s=16, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "ids_a": rng.randint(5, arch.vocab_size, (b, s)).astype(np.int32),
        "mask_a": np.ones((b, s), np.int32),
        "ids_b": rng.randint(5, arch.vocab_size, (b, s)).astype(np.int32),
        "mask_b": np.ones((b, s), np.int32),
        "target": rng.rand(b).astype(np.float32),
        "valid": np.ones((b,), np.int32),
    }


def _cfg(cls):
    return cls(lr=1e-3, warmup_ratio=0.25, batch_size=8, bf16=False)


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

def test_pp_forward_matches_plain_and_jax(eight_devices):
    """data 1 × pipe 4 (× seq 2, which replicates): equal to the plain
    forward and to the JAX package's pipelined forward."""
    jarch = JAX_PRESETS["tiny-test"].replace(num_layers=4, **NO_DROP)
    arch = _arch(4)
    jp = jax_init(jax.random.PRNGKey(0), jarch)
    params = params_from_jax(jax.tree.map(np.asarray, jp), arch)
    ids, mask = _batch(arch)
    got = _pp(params, ids, mask, arch, _mesh(data=1, pipe=4, seq=2))
    want = jax_forward_pp(jp, jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy()), arch=jarch,
                          mesh=jax_make_mesh(data=1, pipe=4, seq=2), precision=JAX_FP32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), _plain(params, ids, mask, arch).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_pp_composes_with_dp():
    arch = _arch(4)
    params = _params(arch, 1)
    ids, mask = _batch(arch, seed=1)
    got = _pp(params, ids, mask, arch, _mesh(data=2, pipe=4), microbatches=4)
    np.testing.assert_allclose(got.numpy(), _plain(params, ids, mask, arch).numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m", [1, 2, 8])
def test_pp_microbatch_counts(m):
    arch = _arch(2)
    params = _params(arch, 2)
    ids, mask = _batch(arch, seed=2)
    got = _pp(params, ids, mask, arch, _mesh(data=1, pipe=2, index=4), microbatches=m)
    np.testing.assert_allclose(got.numpy(), _plain(params, ids, mask, arch).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_pp_grads_match_plain():
    """The backward pipeline falls out of autograd through the stage
    copies: the same parameter gradients as the plain forward."""
    arch = _arch(4)
    params = _trainable(_params(arch, 3))
    ids, mask = _batch(arch, seed=3)
    tgt = torch.from_numpy(np.random.RandomState(9).randn(8, arch.hidden_size).astype(np.float32))
    mesh = _mesh(data=2, pipe=4)
    grads = []
    for fwd in (lambda p: _pp(p, ids, mask, arch, mesh), lambda p: _plain(p, ids, mask, arch)):
        loss = (mean_pool(fwd(params), mask) - tgt).square().mean()
        grads.append(torch.autograd.grad(loss, _stack_leaves(params)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_pp_remat_matches(dropout):
    """Each stage recomputed in the backward gives the same gradients; with
    dropout on, the recompute draws the forward's masks (the generator is
    put back to the stage's entry)."""
    arch = _arch(4, hidden_dropout=dropout)
    params = _trainable(_params(arch, 4))
    ids, mask = _batch(arch, b=4, seed=4)
    mesh = _mesh(data=1, pipe=4, seq=2)
    grads = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(0)
        h = _pp(params, ids, mask, arch, mesh, remat=remat, deterministic=dropout == 0.0,
                generator=gen)
        grads.append(torch.autograd.grad(h.square().mean(), _stack_leaves(params)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------

def test_pp_train_step_matches_jax_and_plain(eight_devices):
    """The bi-encoder step with pp_mesh (data 2 × pipe 4) against the JAX
    package's pipelined step (losses rtol 1e-5; parameters after two steps
    rtol 1e-4, atol 2e-6) and against the port's plain step."""
    jarch = JAX_PRESETS["tiny-test"].replace(num_layers=4, **NO_DROP)
    arch = _arch(4)
    jp = {"encoder": jax_init(jax.random.PRNGKey(0), jarch)}
    jtx = jax_make_optimizer(_cfg(JaxTrainConfig), 8, params_example=jp)
    jstate = jax_init_train_state(jax.tree.map(jnp.array, jp), jtx)
    jstep = jax_bi_step(jarch, jtx, loss_type="cosine_mse", precision=JAX_FP32,
                        pp_mesh=jax_make_mesh(data=2, pipe=4))
    tparams = {"encoder": params_from_jax(jax.tree.map(np.asarray, jp["encoder"]), arch)}
    states, steps = [], []
    for pp in (_mesh(data=2, pipe=4), None):
        tx = make_optimizer(_cfg(TrainConfig), 8, params_example=tparams)
        states.append(init_train_state(tparams, tx, device="cpu"))
        steps.append(make_bi_encoder_train_step(arch, tx, loss_type="cosine_mse",
                                                precision=FP32_PRECISION, device="cpu",
                                                pp_mesh=pp))
    for seed in (0, 1):
        batch = _pair_batch(arch, seed=seed)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        metrics = []
        for i in range(2):
            states[i], m = steps[i](states[i], batch)
            metrics.append(float(m["loss"]))
        np.testing.assert_allclose(metrics[0], float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(metrics[0], metrics[1], rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    for st in states:
        got = _flat(st.params)
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=2e-6, err_msg=k)


def test_pp_train_step_with_dropout():
    """Dropout through the ticks: the loss finite and falling, and two
    identical microbatches get different masks (each (data shard,
    microbatch, layer) draws its own)."""
    arch = _arch(4, hidden_dropout=0.1)
    mesh = _mesh(data=2, pipe=4)
    params = {"encoder": _params(arch)}
    tx = make_optimizer(TrainConfig(lr=1e-3, warmup_ratio=0.0, bf16=False), 100,
                        params_example=params)
    st = init_train_state(params, tx, device="cpu")
    step = make_bi_encoder_train_step(arch, tx, loss_type="cosine_mse", precision=FP32_PRECISION,
                                      device="cpu", pp_mesh=mesh)
    batch = _pair_batch(arch)
    losses = []
    for _ in range(8):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    ids, mask = _batch(arch, b=1, ragged=False)
    rows = _pp(st.params["encoder"], ids.repeat(8, 1), mask.repeat(8, 1), arch, mesh,
               microbatches=4, deterministic=False, generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(rows[0], rows[1])   # microbatches 0 and 1 of data shard 0
    same = _pp(st.params["encoder"], ids.repeat(8, 1), mask.repeat(8, 1), arch, mesh,
               microbatches=4)
    assert torch.equal(same[0], same[1])


def test_pp_mlm_step():
    arch = _arch(4)
    params = {"encoder": _params(arch), "mlm_bias": torch.zeros((arch.vocab_size,))}
    tx = make_optimizer(TrainConfig(lr=1e-3, warmup_ratio=0.0, bf16=False), 100,
                        params_example=params)
    st = init_train_state(params, tx, device="cpu")
    step = make_mlm_train_step(arch, tx, mask_token_id=4, precision=FP32_PRECISION, device="cpu",
                               pp_mesh=_mesh(data=2, pipe=4))
    ids, mask = _batch(arch)
    losses = []
    for _ in range(6):
        st, m = step(st, {"ids": ids, "mask": mask})
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_pp_classifier_step_matches_plain():
    """Including the pooler tail, which runs after the pipeline."""
    arch = _arch(4)
    assert arch.has_pooler
    rng = np.random.RandomState(3)
    batch = {
        "ids": rng.randint(5, arch.vocab_size, (8, 16)).astype(np.int32),
        "mask": np.ones((8, 16), np.int32),
        "type_ids": rng.randint(0, 2, (8, 16)).astype(np.int32),
        "labels": rng.randint(0, 3, (8,)).astype(np.int32),
        "valid": np.ones((8,), np.int32),
    }
    out = []
    for pp in (_mesh(data=2, pipe=4), None):
        params = {"encoder": _params(arch),
                  "head": init_classifier_head(torch.Generator().manual_seed(1),
                                               arch.hidden_size, 3, device="cpu")}
        tx = make_optimizer(_cfg(TrainConfig), 8, params_example=params)
        st = init_train_state(params, tx, device="cpu")
        step = make_classifier_train_step(arch, tx, precision=FP32_PRECISION, device="cpu",
                                          pp_mesh=pp)
        losses = []
        for _ in range(3):
            st, m = step(st, batch)
            losses.append(float(m["loss"]))
        out.append((losses, _leaves(st.params)))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4, atol=2e-6)


def _refusal(case):
    arch = _arch(4)
    params = _params(arch, 5)
    ids, mask = _batch(arch)
    mesh = _mesh(data=1, pipe=4, seq=2)
    if case == "num_layers":
        return lambda: _pp(params, ids, mask, arch.replace(num_layers=3), mesh)
    if case == "microbatches":
        return lambda: _pp(params, ids, mask, arch, mesh, microbatches=3)
    if case == "shared":
        return lambda: _pp(params, ids, mask, arch.replace(share_layers=True), mesh)
    if case == "MoE":
        return lambda: _pp(params, ids, mask, arch.replace(num_experts=4), mesh)
    if case == "B=8 must divide":
        return lambda: _pp(params, ids, mask, arch, _mesh(data=3, pipe=2))
    if case == "head_mask":
        head = {"w": torch.zeros((64, 3)), "b": torch.zeros((3,))}
        return lambda: classifier_forward({"encoder": params, "head": head}, ids, mask, arch=arch,
                                          head_mask=torch.ones((4, 4)), pp_mesh=mesh)
    return lambda: bi_encoder_loss(   # "MoE archs are not supported with pp_mesh"
        {"encoder": params}, {"ids_a": ids, "mask_a": mask, "ids_b": ids, "mask_b": mask,
                              "target": torch.zeros(8)},
        arch=arch.replace(num_experts=4), deterministic=True, pp_mesh=mesh)


@pytest.mark.parametrize("case", ["num_layers", "microbatches", "shared", "MoE",
                                  "B=8 must divide", "head_mask", "with pp_mesh"])
def test_pp_validation_errors(case):
    with pytest.raises(ValueError, match=case):
        _refusal(case)()


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sts_file(tmp_path_factory):
    words = ["cat", "dog", "sat", "on", "the", "mat", "big", "red", "bird", "ran"]
    rng = np.random.RandomState(0)
    path = tmp_path_factory.mktemp("sts") / "sts.tsv"
    path.write_text("\n".join(
        f"{' '.join(rng.choice(words, 5))}\t{' '.join(rng.choice(words, 5))}\t"
        f"{rng.uniform(0, 5):.2f}" for _ in range(16)))
    return str(path)


def test_cli_train_sts_pipe_2_on_cpu_positions(tmp_path, sts_file, capsys):
    cli_main(["train-sts", "--data", sts_file, "--arch", "tiny-test", "--vocab-size", "128",
              "--fp32", "--batch-size", "4", "--max-len", "16", "--no-eval", "--pipe", "2",
              "--save-path", str(tmp_path / "run"), "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(res["best_metric"])
    with pytest.raises(SystemExit, match="--packed and --pipe are mutually exclusive"):
        cli_main(["train-sts", "--data", sts_file, "--arch", "tiny-test", "--vocab-size", "128",
                  "--fp32", "--packed", "--pipe", "2", "--save-path", str(tmp_path / "p"),
                  "--device", "cpu"])
