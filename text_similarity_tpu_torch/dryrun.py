"""A dry run of every mesh axis on n positions (port of the reference's
``__graft_entry__.dryrun_multichip``).

    python -m text_similarity_tpu_torch.dryrun [N] [--device cpu]

One process drives the n positions (``core.mesh``). By default the
positions cycle over the visible cards (``cuda:i mod cards``: four
positions on one card share it), or are n positions on the CPU with
``device="cpu"``; ``devices`` names them explicitly. It runs, on the
tiny-test arch with random weights and numpy-seeded data:

- a data × model (Megatron, model 2 where n is even) bi-encoder softmax
  step on a state placed by ``param_pspecs``: the loss finite;
- ring and Ulysses attention over a seq axis of n: finite, agreeing within
  1e-5;
- a sharded brute-force index over an index axis of n (K2 a shard on the
  card): each of 4 rows finds itself first;
- a sharded IVF index (K1 a shard on the card): recall@10 ≥ 0.9 against the
  sharded brute force;
- a pipe-2 cosine-MSE step (``pp_mesh``) twice: finite losses, the weights
  moved;
- an expert-parallel step (expert 2, 4 experts, top-2): finite loss and
  ``moe_aux``.

It prints one summary line and returns the readings.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from .core.config import ARCH_PRESETS, IndexConfig, TrainConfig
from .core.mesh import SEQ_AXIS, PartitionSpec as P, make_mesh
from .core.precision import resolve_device
from .index.sharded import ShardedBruteForceIndex, ShardedIVFIndex
from .models.encoder import init_params, param_pspecs
from .ops.attention import multi_head_attention
from .train import (
    init_sharded_train_state, init_train_state, make_bi_encoder_train_step, make_optimizer,
    shard_batch_for,
)


def _positions(n: int, device) -> list:
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def _pair_batch(rng, arch, b, s, target):
    return {
        "ids_a": rng.randint(5, arch.vocab_size, (b, s)).astype(np.int32),
        "mask_a": np.ones((b, s), np.int32),
        "ids_b": rng.randint(5, arch.vocab_size, (b, s)).astype(np.int32),
        "mask_b": np.ones((b, s), np.int32),
        "target": target,
        "valid": np.ones((b,), np.int32),
    }


def _unit(x: np.ndarray) -> np.ndarray:
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def dryrun_multichip(n_devices: int, device="cuda", devices: Optional[Sequence] = None) -> dict:
    """Run one step or query on every mesh axis over ``n_devices``
    positions (see the module note) → the readings; raises where a check
    fails."""
    devs = list(devices) if devices is not None else _positions(n_devices, device)
    if len(devs) != n_devices:
        raise ValueError(f"{len(devs)} devices given for {n_devices} positions")
    arch = ARCH_PRESETS["tiny-test"]
    cfg = TrainConfig(batch_size=n_devices * 2)
    s = 16
    rng = np.random.RandomState(0)

    # data × model: the bi-encoder softmax step on a Megatron-placed state
    model_par = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(data=n_devices // model_par, model=model_par, devices=devs)
    gen = torch.Generator().manual_seed(0)
    params = {
        "encoder": init_params(arch, gen),
        "head": {"w": torch.randn((3 * arch.hidden_size, 3), generator=gen) * 0.02,
                 "b": torch.zeros((3,))},
    }
    specs = {"encoder": param_pspecs(arch), "head": {"w": P(None, None), "b": P(None)}}
    tx = make_optimizer(cfg, total_steps=10, params_example=params)
    state = init_sharded_train_state(params, tx, mesh, param_specs=specs)
    step = make_bi_encoder_train_step(arch, tx, loss_type="softmax", device=devs[0].type)
    b = cfg.batch_size
    batch = _pair_batch(rng, arch, b, s, rng.randint(0, 3, (b,)).astype(np.int32))
    state, metrics = step(state, shard_batch_for(mesh, batch))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    # context parallelism: ring and Ulysses over a seq axis of n
    seq_devs = make_mesh(data=1, seq=n_devices, devices=devs).axis_devices(SEQ_AXIS)
    bq, sq, dq = 2, 8 * n_devices, 16

    def pieces(x):
        return [c.to(d) for c, d in zip(x.chunk(n_devices, dim=1), seq_devs)]

    def cp(impl, heads):
        qkv = pieces(torch.full((bq, sq, heads, dq), 0.1))
        mask = pieces(torch.ones((bq, sq), dtype=torch.int32))
        out = multi_head_attention(qkv, qkv, qkv, mask=mask, impl=impl, cp_group=seq_devs)
        return torch.cat([o.to(seq_devs[0]) for o in out], dim=1)

    if not torch.isfinite(cp("ring", 2)).all():
        raise AssertionError("ring attention is not finite")
    ring_u, uly = cp("ring", n_devices), cp("ulysses", n_devices)
    cp_gap = float((ring_u - uly).abs().max())
    if cp_gap > 1e-5:
        raise AssertionError(f"Ulysses and ring disagree by {cp_gap}")

    # the index axis: sharded brute force (K2 a shard), sharded IVF (K1)
    idx_mesh = make_mesh(data=1, index=n_devices, devices=devs)
    emb = _unit(np.random.RandomState(2).randn(64 * n_devices, 32))
    brute = ShardedBruteForceIndex.build(idx_mesh, torch.from_numpy(emb).to(devs[0]))
    _, ids = brute.query(torch.from_numpy(emb[:4]).to(devs[0]), k=3)
    if not (ids[:, 0] == np.arange(4)).all():
        raise AssertionError(f"sharded self-retrieval failed: {ids[:, 0]}")
    n_rows = 512 * n_devices
    rngh = np.random.RandomState(3)
    centers = rngh.randn(16 * n_devices, 32).astype(np.float32)
    emb2 = _unit(centers[np.sort(rngh.randint(0, len(centers), n_rows))] * 3.0
                 + rngh.randn(n_rows, 32).astype(np.float32))
    emb2_t = torch.from_numpy(emb2).to(devs[0])
    ivf = ShardedIVFIndex.build(
        idx_mesh, emb2_t, IndexConfig(num_clusters=8 * n_devices, num_probes=6, kmeans_iters=4),
        generator=torch.Generator(device=devs[0]).manual_seed(4),
    )
    n_q = 32
    _, ivf_i = ivf.query(emb2_t[:n_q], k=10)
    _, oracle_i = ShardedBruteForceIndex.build(idx_mesh, emb2_t).query(emb2_t[:n_q], k=10)
    recall = float(np.mean([len(set(ivf_i[r]) & set(oracle_i[r])) / 10 for r in range(n_q)]))
    if recall < 0.9:
        raise AssertionError(f"sharded IVF recall@10 {recall}")

    # pipeline parallelism: the bi-encoder step with pp_mesh, twice
    n_pipe = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    pp_losses = []
    if n_pipe > 1:
        pp_mesh = make_mesh(data=n_devices // n_pipe, pipe=n_pipe, devices=devs)
        pp_params = {"encoder": init_params(arch, torch.Generator().manual_seed(7))}
        pp_tx = make_optimizer(cfg, total_steps=10, params_example=pp_params)
        pp_state = init_train_state(pp_params, pp_tx, device=devs[0])
        pp_step = make_bi_encoder_train_step(arch, pp_tx, loss_type="cosine_mse",
                                             device=devs[0].type, pp_mesh=pp_mesh)
        pb = 2 * n_devices
        pp_batch = _pair_batch(rng, arch, pb, s, rng.rand(pb).astype(np.float32))
        w_before = pp_state.params["encoder"]["embeddings"]["word"].detach().clone()
        for _ in range(2):
            pp_state, pp_m = pp_step(pp_state, pp_batch)
            pp_losses.append(float(pp_m["loss"]))
        if not np.all(np.isfinite(pp_losses)):
            raise AssertionError(f"non-finite pp loss {pp_losses}")
        if torch.equal(w_before, pp_state.params["encoder"]["embeddings"]["word"].detach()):
            raise AssertionError("pp update was a no-op")

    # expert parallelism: an MoE step with the experts over the expert axis
    n_ep = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    moe = {}
    if n_ep > 1:
        ep_mesh = make_mesh(data=n_devices // n_ep, expert=n_ep, devices=devs)
        moe_arch = arch.replace(num_experts=2 * n_ep, expert_top_k=2)
        moe_params = {"encoder": init_params(moe_arch, torch.Generator().manual_seed(8))}
        moe_tx = make_optimizer(cfg, total_steps=10, params_example=moe_params)
        moe_state = init_sharded_train_state(moe_params, moe_tx, ep_mesh,
                                              param_specs={"encoder": param_pspecs(moe_arch)})
        moe_step = make_bi_encoder_train_step(moe_arch, moe_tx, loss_type="cosine_mse",
                                              device=devs[0].type)
        eb = 2 * n_devices
        moe_batch = _pair_batch(rng, arch, eb, s, rng.rand(eb).astype(np.float32))
        moe_state, moe_m = moe_step(moe_state, shard_batch_for(ep_mesh, moe_batch))
        moe = {"loss": float(moe_m["loss"]), "aux": float(moe_m["moe_aux"])}
        if not (np.isfinite(moe["loss"]) and np.isfinite(moe["aux"])):
            raise AssertionError(f"non-finite MoE loss/aux {moe}")

    print(
        f"dryrun_multichip({n_devices}) ok on {sorted({str(d) for d in devs})}: "
        f"loss={loss:.4f} dp×tp={ {a: mesh.shape[a] for a in ('data', 'model')} } "
        f"+ cp ring+ulysses (seq={n_devices}, max|Δ|={cp_gap:.1e}) "
        + (f"+ pp train step (pipe={n_pipe}, loss={pp_losses[-1]:.4f}) " if pp_losses
           else "+ pp skipped (1 device) ")
        + (f"+ ep MoE train step (expert={n_ep}, {2 * n_ep} experts, loss={moe['loss']:.4f}, "
           f"aux={moe['aux']:.2f}) " if moe else "+ ep skipped (1 device) ")
        + f"+ sharded index (index={n_devices}) "
        f"+ sharded IVF (recall@10={recall:.2f} vs brute-force oracle, "
        f"{ivf.centroids.shape[0]} global clusters over {n_devices} shards)",
        flush=True,
    )
    return {"loss": loss, "cp_max_abs": cp_gap, "recall_at_10": recall, "pp_losses": pp_losses,
            "moe": moe}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="positions (default: the visible cards, or 8 on the CPU)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    n = args.n
    if n is None:
        n = torch.cuda.device_count() if resolve_device(args.device).type == "cuda" else 8
    dryrun_multichip(n, device=args.device)


if __name__ == "__main__":
    main()
