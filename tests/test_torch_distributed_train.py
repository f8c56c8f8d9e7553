"""Distributed training on the one-controller mesh against the JAX package on
its 8 virtual CPU devices: the placement specs, the data × model (Megatron)
and FSDP bi-encoder steps over two steps, the expert-parallel forward and
step, a data-parallel MNRL step against the mesh-less one, AdamW over
pieces, a sharded run's checkpoints read by the JAX package, and
``dryrun_multichip``. The port places its 8 positions on the one CPU (a
device list may repeat a device). Tiny-test arch, f32, dropout 0, inputs
from numpy seeds; the limits of ``tests/test_torch_train_steps.py``: losses
within rtol 1e-5, parameters after the steps within rtol 1e-4, atol 2e-6
(the first step has lr 0)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from text_similarity_tpu.core.config import ARCH_PRESETS as JAX_PRESETS
from text_similarity_tpu.core.config import TrainConfig as JaxTrainConfig
from text_similarity_tpu.core.mesh import make_mesh as jax_make_mesh
from text_similarity_tpu.core.precision import FP32_PRECISION as JAX_FP32
from text_similarity_tpu.models import encoder_forward as jax_forward
from text_similarity_tpu.models import init_params as jax_init
from text_similarity_tpu.models.encoder import fsdp_param_pspecs as jax_fsdp_pspecs
from text_similarity_tpu.models.encoder import param_pspecs as jax_pspecs
from text_similarity_tpu.models.sentence_encoder import SentenceEncoder as JaxSentenceEncoder
from text_similarity_tpu.train import init_sharded_train_state as jax_init_sharded
from text_similarity_tpu.train import make_bi_encoder_train_step as jax_bi_step
from text_similarity_tpu.train import make_optimizer as jax_make_optimizer
from text_similarity_tpu.train import shard_batch_for as jax_shard_batch_for
from text_similarity_tpu_torch.core import checkpoint as ckpt
from text_similarity_tpu_torch.core.config import ARCH_PRESETS, TrainConfig
from text_similarity_tpu_torch.core.mesh import (
    PartitionSpec as P, ShardedLeaf, make_mesh, place, shard_leaf, unshard,
)
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab
from text_similarity_tpu_torch.dryrun import dryrun_multichip
from text_similarity_tpu_torch.models import (
    SentenceEncoder, encoder_forward, fsdp_param_pspecs, init_params, param_pspecs,
    params_from_jax,
)
from text_similarity_tpu_torch.train import (
    AdamW, DevicePrefetcher, Trainer, init_sharded_train_state, init_train_state,
    linear_warmup_schedule, make_bi_encoder_train_step, make_optimizer, shard_batch_for,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU8 = ["cpu"] * 8
NO_DROP = dict(hidden_dropout=0.0, attention_dropout=0.0)
HEAD_SPECS = {"w": P(None, None), "b": P(None)}
WORDS = ["cat", "dog", "sat", "on", "the", "mat", "rug", "big", "small", "red", "blue",
         "fast", "slow", "bird", "fish", "ran", "jumped", "house", "tree", "river"]


def _np(tree):
    return jax.tree.map(np.array, jax.device_get(tree))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, p))
        else:
            out[p] = v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _port_tree(jtree, arch):
    """A JAX {"encoder", ...} tree → the port's tensors."""
    return {k: params_from_jax(v, arch) if k == "encoder" else
            {kk: torch.from_numpy(vv) for kk, vv in v.items()}
            for k, v in _np(jtree).items()}


def _batches(vocab, n, b=16, s=16, loss="cosine_mse", seed=0):
    """n pair batches with ragged masks (numpy)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        batch = {"valid": np.ones((b,), np.int32)}
        for side in ("a", "b"):
            mask = np.ones((b, s), np.int32)
            for r in range(b):
                mask[r, s - 1 - (r % 5):] = 0
            batch[f"ids_{side}"] = (rng.randint(5, vocab, (b, s)) * mask).astype(np.int32)
            batch[f"mask_{side}"] = mask
        batch["target"] = (rng.randint(0, 3, (b,)).astype(np.int32) if loss == "softmax"
                           else rng.rand(b).astype(np.float32))
        out.append(batch)
    return out


def _jax_params(jarch, head: bool):
    jp = {"encoder": jax_init(jax.random.PRNGKey(0), jarch)}
    if head:
        rng = np.random.default_rng(1)
        jp["head"] = {"w": jnp.asarray(rng.standard_normal((3 * jarch.hidden_size, 3)) * 0.02,
                                       jnp.float32),
                      "b": jnp.zeros((3,), jnp.float32)}
    return jp


def _init(arch):
    return init_params(arch, torch.Generator().manual_seed(0))


def _cfg(cls):
    return cls(lr=1e-3, warmup_ratio=0.25, batch_size=16, bf16=False)


def _sharded_parity(mesh_kw, spec_of, loss_type, arch_kw=None, n_steps=2):
    """The JAX package's sharded step and the port's over the same placed
    weights and batches → (the port's state, the JAX state)."""
    arch_kw = {**NO_DROP, **(arch_kw or {})}
    jarch = JAX_PRESETS["tiny-test"].replace(**arch_kw)
    arch = ARCH_PRESETS["tiny-test"].replace(**arch_kw)
    head = loss_type == "softmax"
    jp = _jax_params(jarch, head)
    jspecs, tspecs = spec_of(jarch, arch)
    if head:
        jspecs["head"], tspecs["head"] = {"w": JP(None, None), "b": JP(None)}, HEAD_SPECS

    jmesh = jax_make_mesh(**mesh_kw)
    jtx = jax_make_optimizer(_cfg(JaxTrainConfig), 8, params_example=jp)
    tparams = _port_tree(jp, arch)
    jstate = jax_init_sharded(jax.tree.map(jnp.array, jp), jtx, jmesh, param_specs=jspecs)
    jstep = jax_bi_step(jarch, jtx, loss_type=loss_type, precision=JAX_FP32)
    mesh = make_mesh(**mesh_kw, devices=CPU8)
    ttx = make_optimizer(_cfg(TrainConfig), 8, params_example=tparams)
    tstate = init_sharded_train_state(tparams, ttx, mesh, param_specs=tspecs)
    tstep = make_bi_encoder_train_step(arch, ttx, loss_type=loss_type, precision=FP32_PRECISION,
                                       device="cpu")
    for b in _batches(arch.vocab_size, n_steps, loss=loss_type):
        jstate, jm = jstep(jstate, jax_shard_batch_for(jmesh, jax.tree.map(jnp.asarray, b)))
        tstate, tm = tstep(tstate, shard_batch_for(mesh, b))
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    want, got = _flat(_np(jstate.params)), _flat(unshard(tstate.params))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=2e-6, err_msg=k)
    return tstate, jstate


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

ARCHS = {
    "dense": {},
    "moe": dict(num_experts=4, expert_top_k=2),
    "albert": dict(share_layers=True, embed_factor_size=32),
    "no_pooler": dict(has_pooler=False, has_token_type=False),
    "projection": dict(projection_dim=16),
}


def _spec_tree(tree):
    return {k: _spec_tree(v) if isinstance(v, dict) else tuple(v) for k, v in tree.items()}


@pytest.mark.parametrize("fsdp", [False, True], ids=["param_pspecs", "fsdp_param_pspecs"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_pspecs_equal_the_jax_trees(name, fsdp):
    jarch = JAX_PRESETS["tiny-test"].replace(**ARCHS[name])
    arch = ARCH_PRESETS["tiny-test"].replace(**ARCHS[name])
    want = (jax_fsdp_pspecs if fsdp else jax_pspecs)(jarch)
    got = (fsdp_param_pspecs if fsdp else param_pspecs)(arch)
    assert _spec_tree(got) == _spec_tree(want)


def test_pieces_own_their_storage_and_gather_back():
    """Positions that share a device get pieces that are no views of one
    another (the optimizer updates them in place); an uneven split raises."""
    mesh = make_mesh(data=4, model=2, devices=CPU8)
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    leaf = shard_leaf(x, mesh, P("data", None, "model"))
    assert len(leaf.pieces) == 8 and all(p.shape == (1, 6, 4) for p in leaf.pieces)
    assert len({p.data_ptr() for p in leaf.pieces}) == 8
    assert all(p.is_contiguous() and p.data_ptr() != x.data_ptr() for p in leaf.pieces)
    assert torch.equal(unshard(leaf), x)
    rep = shard_leaf(x, mesh, P())
    assert len(rep.pieces) == 1 and rep.pieces[0].data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="does not split evenly"):
        shard_leaf(torch.zeros(5, 8), mesh, P("data"))


# ---------------------------------------------------------------------------
# Sharded steps against the JAX package
# ---------------------------------------------------------------------------

def test_dp_tp_softmax_step_matches_jax(eight_devices):
    """data 4 × model 2, the Megatron placement (the reference's dryrun)."""
    tstate, _ = _sharded_parity(
        dict(data=4, model=2), lambda ja, a: ({"encoder": jax_pspecs(ja)},
                                              {"encoder": param_pspecs(a)}), "softmax")
    qw = tstate.params["encoder"]["layers"]["attn"]["q"]["w"]
    assert qw.spec == P(None, None, "model") and [p.shape for p in qw.pieces] == [(2, 64, 32)] * 2


def test_fsdp_step_matches_jax_and_its_pieces_are_the_jax_shards(eight_devices):
    """data 8, every leaf placed by fsdp_param_pspecs (the reference's
    tests/test_train_multichip.py FSDP step): each piece's shape equals the
    JAX shard's, each moment lies beside its piece, no piece aliases
    another."""
    tstate, jstate = _sharded_parity(
        dict(data=8), lambda ja, a: ({"encoder": jax_fsdp_pspecs(ja)},
                                     {"encoder": fsdp_param_pspecs(a)}), "cosine_mse")
    jflat = jax.tree_util.tree_flatten_with_path(jstate.params)[0]
    pieces = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                pieces[path + (k,)] = v

    walk(tstate.params, ())
    for jpath, jleaf in jflat:
        key = tuple(p.key for p in jpath)
        leaf = pieces[key]
        assert isinstance(leaf, ShardedLeaf)
        assert tuple(leaf.pieces[0].shape) == tuple(jleaf.addressable_shards[0].data.shape), key
    ptrs = [p.data_ptr() for leaf in pieces.values() for p in leaf.pieces]
    assert len(set(ptrs)) == len(ptrs)
    mu = tstate.opt_state["mu"]["encoder"]["layers"]["mlp"]["in"]["w"]
    assert [m.shape for m in mu.pieces] == [(2, 64, 16)] * 8


@pytest.fixture(scope="module")
def moe_setup(eight_devices):
    jarch = JAX_PRESETS["tiny-test"].replace(num_experts=4, expert_top_k=2, **NO_DROP)
    arch = ARCH_PRESETS["tiny-test"].replace(num_experts=4, expert_top_k=2, **NO_DROP)
    jp = jax_init(jax.random.PRNGKey(0), jarch)
    rng = np.random.RandomState(5)
    ids = rng.randint(5, arch.vocab_size, (8, 16)).astype(np.int32)
    mask = np.ones((8, 16), np.int32)
    mask[3, 9:] = 0
    return jarch, arch, jp, ids, mask


def test_ep_forward_matches_jax(moe_setup):
    """data 2 × expert 4: the routing and capacity stay global, so the
    states, moe_aux and moe_drop equal the JAX package's sharded forward
    (as tests/test_moe.py holds it to its replicated forward)."""
    jarch, arch, jp, ids, mask = moe_setup
    jmesh = jax_make_mesh(data=2, expert=4)
    jsharded = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(jmesh, s)),
                            jp, jax_pspecs(jarch))
    rows = NamedSharding(jmesh, JP("data", None))
    put = lambda a: jax.device_put(jnp.asarray(a), rows)  # noqa: E731
    want = jax.jit(lambda p, i, m: jax_forward(p, i, m, arch=jarch, precision=JAX_FP32))(
        jsharded, put(ids), put(mask))
    mesh = make_mesh(data=2, expert=4, devices=CPU8)
    placed = place(params_from_jax(_np(jp), arch), mesh, param_pspecs(arch))
    assert len(placed["layers"]["mlp"]["in"]["w"].pieces) == 4
    got = encoder_forward(placed, torch.from_numpy(ids), torch.from_numpy(mask), arch=arch,
                          precision=FP32_PRECISION)
    np.testing.assert_allclose(got.last_hidden_state.numpy(), np.asarray(want.last_hidden_state),
                               atol=2e-5)
    np.testing.assert_allclose(float(got.moe_aux), float(want.moe_aux), atol=1e-5)
    np.testing.assert_allclose(float(got.moe_drop), float(want.moe_drop), atol=1e-5)


def test_ep_step_matches_jax(eight_devices):
    _sharded_parity(dict(data=2, expert=4),
                    lambda ja, a: ({"encoder": jax_pspecs(ja)}, {"encoder": param_pspecs(a)}),
                    "cosine_mse", arch_kw=dict(num_experts=4, expert_top_k=2), n_steps=1)


def test_a_model_axis_leaf_off_the_megatron_layout_raises():
    arch = ARCH_PRESETS["tiny-test"]
    specs = param_pspecs(arch)
    specs["layers"]["attn"]["o"]["w"] = P(None, None, "model")   # columns, not rows
    placed = place(_init(arch), make_mesh(data=4, model=2, devices=CPU8), specs)
    with pytest.raises(ValueError, match="param_pspecs' layout"):
        encoder_forward(placed, torch.zeros((8, 4), dtype=torch.long), arch=arch)


# ---------------------------------------------------------------------------
# The port's own: MNRL, AdamW over pieces, checkpoints, the dry run
# ---------------------------------------------------------------------------

def test_dp_mnrl_step_equals_the_meshless_step():
    """The loss runs once over the global batch on the first device, so
    the in-batch negatives span every data position: the data-8 step equals
    the mesh-less one."""
    arch = ARCH_PRESETS["tiny-test"].replace(**NO_DROP)
    params = {"encoder": _init(arch)}
    batches = _batches(arch.vocab_size, 2, loss="mnrl", seed=3)
    out = []
    for mesh in (None, make_mesh(data=8, devices=CPU8)):
        tx = make_optimizer(_cfg(TrainConfig), 8, params_example=params)
        st = (init_train_state(params, tx, device="cpu") if mesh is None
              else init_sharded_train_state(params, tx, mesh))
        step = make_bi_encoder_train_step(arch, tx, loss_type="mnrl", precision=FP32_PRECISION,
                                          device="cpu")
        losses = []
        for b in batches:
            st, m = step(st, b if mesh is None else shard_batch_for(mesh, b))
            losses.append(float(m["loss"]))
        out.append((losses, _flat(unshard(st.params))))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    for k, w in out[0][1].items():
        np.testing.assert_allclose(out[1][1][k], w, rtol=1e-4, atol=2e-6, err_msg=k)


def test_adamw_over_pieces_equals_the_whole_tree_with_the_clip_active():
    """Replicated, FSDP and model-split leaves: the global norm counts every
    piece once, so the clipped update equals the whole tree's."""
    rng = np.random.RandomState(0)
    whole = {"a": torch.from_numpy(rng.randn(8, 6).astype(np.float32)),
             "b": {"w": torch.from_numpy(rng.randn(4, 8).astype(np.float32)),
                   "bias": torch.from_numpy(rng.randn(8).astype(np.float32))}}
    grads = [{"a": torch.from_numpy(rng.randn(8, 6).astype(np.float32) * 3),
              "b": {"w": torch.from_numpy(rng.randn(4, 8).astype(np.float32) * 3),
                    "bias": torch.from_numpy(rng.randn(8).astype(np.float32) * 3)}}
             for _ in range(3)]
    norm = float(torch.linalg.vector_norm(torch.cat([g.flatten() for g in
                                                     (grads[0]["a"], grads[0]["b"]["w"],
                                                      grads[0]["b"]["bias"])])))
    assert norm > 1.0   # the clip is active
    mesh = make_mesh(data=4, model=2, devices=CPU8)
    specs = {"a": P("data", None), "b": {"w": P(None, "model"), "bias": P()}}
    tx_w = AdamW(linear_warmup_schedule(1e-2, 10, 1), weight_decay=0.1, max_grad_norm=1.0)
    tx_s = AdamW(linear_warmup_schedule(1e-2, 10, 1), weight_decay=0.1, max_grad_norm=1.0)
    pw = {"a": whole["a"].clone(), "b": {k: v.clone() for k, v in whole["b"].items()}}
    ps = place(whole, mesh, specs)
    sw, ss = tx_w.init(pw), tx_s.init(ps)
    for g in grads:
        tx_w.step(pw, g, sw)
        tx_s.step(ps, unshard_like(g, ps), ss)
    for k, w in _flat(pw).items():
        np.testing.assert_allclose(_flat(unshard(ps))[k], w, rtol=1e-6, atol=1e-7, err_msg=k)
    assert ps["a"].pieces[0].shape == (2, 6) and len(ss["mu"]["a"].pieces) == 4


def unshard_like(tree, placed):
    """A whole tree cut as ``placed`` is (gradients for sharded params)."""
    if isinstance(placed, dict):
        return {k: unshard_like(tree[k], v) for k, v in placed.items()}
    return shard_leaf(tree, placed.mesh, placed.spec)


def test_sharded_run_saves_what_the_jax_package_loads(tmp_path, eight_devices):
    """A data × model run through Trainer(mesh=) (the prefetcher splits each
    batch over the data positions): its checkpoint holds whole leaves equal
    to the unsharded state, and the encoder saved from that state gives the
    JAX package the port's embeddings."""
    tok = WordPieceTokenizer(train_wordpiece_vocab([" ".join(WORDS)] * 3, 256, min_freq=1))
    arch = ARCH_PRESETS["tiny-test"].replace(vocab_size=tok.vocab_size, **NO_DROP)
    params = {"encoder": _init(arch)}
    mesh = make_mesh(data=4, model=2, devices=CPU8)
    tx = make_optimizer(_cfg(TrainConfig), 4, params_example=params)
    state = init_sharded_train_state(params, tx, mesh, {"encoder": param_pspecs(arch)})
    step = make_bi_encoder_train_step(arch, tx, loss_type="cosine_mse", precision=FP32_PRECISION,
                                      device="cpu")
    batches = _batches(arch.vocab_size, 3, seed=7)
    placed = list(DevicePrefetcher(iter(batches[:1]), device="cpu", mesh=mesh))
    assert len(placed) == 1 and len(placed[0]) == 4 and placed[0][0]["ids_a"].shape == (4, 16)
    run = tmp_path / "run"
    result = Trainer(step, state, save_path=str(run), device="cpu", mesh=mesh,
                     prefetch=2).execute(lambda e: iter(batches))
    whole = unshard(result["state"].params)
    saved, _, _ = ckpt.restore_checkpoint_raw(ckpt.latest_checkpoint(str(run)))
    for k, w in _flat(whole).items():
        np.testing.assert_array_equal(_flat(saved)[k], w, err_msg=k)

    texts = ["the cat sat on the mat", "a big red bird", "dog ran fast", "house by the river"]
    enc = SentenceEncoder(whole["encoder"], arch, tokenizer=tok, device="cpu",
                          precision=FP32_PRECISION)
    enc.save(str(tmp_path / "enc"))
    jenc = JaxSentenceEncoder.load(str(tmp_path / "enc"), bf16=False)
    np.testing.assert_allclose(enc.encode(texts), np.asarray(jenc.encode(texts)), atol=1e-5)


def test_dryrun_multichip_on_eight_cpu_positions():
    out = dryrun_multichip(8, device="cpu")
    assert np.isfinite(out["loss"]) and out["cp_max_abs"] <= 1e-5
    assert out["recall_at_10"] >= 0.9
    assert len(out["pp_losses"]) == 2 and np.isfinite(out["pp_losses"]).all()
    assert np.isfinite(out["moe"]["loss"]) and np.isfinite(out["moe"]["aux"])
