"""The port's training step and collectives.

- ``make_train_step`` (collective mode, one process) against
  ``byteps_tpu.jax.training.make_train_step`` on the 8-device CPU mesh:
  the same tiny LM weights (moved over with ``from_flax``), the same
  batches, the same optimizer hyper-parameters, loss and parameters
  compared after every step.
- ``tree_all_reduce`` / ``tree_broadcast`` and the collective step across
  two gloo processes, against numpy sums and a one-process run; both
  levels on a 2 x 2 grid of four gloo processes, with NaN on every
  process but the broadcast's root.
- The API's contracts: errors before ``init``, the device rule, the
  int8 rejection in PS mode, ``backward_passes_per_step``.
"""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import byteps_tpu.jax as jbps
import byteps_tpu_torch as bps
from byteps_tpu.jax.training import make_train_step as jax_make_train_step
from byteps_tpu.jax.training import replicate, shard_batch
from byteps_tpu.models.transformer import TransformerLM as FlaxLM
from byteps_tpu.models.transformer import lm_loss as jax_lm_loss
from byteps_tpu.parallel.mesh import MeshSpec, build_mesh
from byteps_tpu_torch.compression import Compression, Compressor
from byteps_tpu_torch.models.transformer import (TransformerLM, from_flax,
                                                 lm_loss)
from byteps_tpu_torch.parallel.hierarchical import (tree_all_reduce,
                                                    tree_broadcast)
from byteps_tpu_torch.training import make_train_step

CFG = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, mlp_dim=64,
           max_len=16)
LR = 1e-3


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    # One intra-op thread, here and in the spawned workers: under pytest
    # -n 6 (xdist) their load starved the JAX package's 8-device CPU
    # collectives in other test workers until XLA aborted them.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("BYTEPS_PS_MODE", "collective")
    yield
    if bps.initialized():
        bps.shutdown()
    torch.set_num_threads(threads)


def _torch_loss(model, tokens):
    return lm_loss(model(tokens), tokens)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_collective_step_matches_jax_mesh(opt):
    """Tolerances. SGD: the two differ by summation order only, so 1e-4
    relative / 1e-6 absolute on parameters after 3 steps. AdamW:
    torch.optim.AdamW(weight_decay=1e-4) and optax.adamw(weight_decay=
    1e-4) apply the same update (decay from the old parameter, eps outside
    the square root); torch's default decay would be 0.01. Adam divides by
    the gradient's own magnitude, so where a gradient is zero up to
    rounding (the key biases: softmax ignores a per-query constant) the
    two can step by up to lr in either direction; those parameters are
    held to lr * steps, the others to 1e-4 / 1e-6 like SGD."""
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, CFG["vocab_size"], size=(8, 16))
               for _ in range(3)]
    fmodel = FlaxLM(**CFG, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, fmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(batches[0], jnp.int32)))

    mesh = build_mesh(MeshSpec(dcn=2, ici=4))
    jbps.init(mesh=mesh)
    tx = (optax.sgd(LR * 100) if opt == "sgd"
          else optax.adamw(LR, weight_decay=1e-4))

    def jloss(p, tokens):
        return jax_lm_loss(fmodel.apply(p, tokens), tokens)

    jstep = jax_make_train_step(jloss, tx, mesh)
    jp = replicate(jax.tree_util.tree_map(jnp.asarray, params), mesh)
    js = replicate(tx.init(jp), mesh)

    bps.init(device="cpu")
    model = TransformerLM(**CFG, dtype=torch.float32, attn_impl="full",
                          device="cpu")
    model.load_state_dict(from_flax(params))
    topt = (torch.optim.SGD(model.parameters(), lr=LR * 100) if opt == "sgd"
            else torch.optim.AdamW(model.parameters(), lr=LR,
                                   weight_decay=1e-4))
    step = make_train_step(_torch_loss, topt)

    for i, b in enumerate(batches):
        jp, js, jl = jstep(jp, js, shard_batch(jnp.asarray(b, jnp.int32),
                                               mesh))
        tl = step(model, torch.as_tensor(b))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5,
                                   err_msg=f"loss, step {i}")
    want = from_flax(jax.tree_util.tree_map(np.asarray, jp))
    for k, p in model.state_dict().items():
        atol = (LR * len(batches) if opt == "adamw" and k.endswith("key.bias")
                else 1e-6)
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=atol, err_msg=k)


# --- two gloo processes -------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _gloo_worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        rng = np.random.default_rng(3)  # the same stream on both ranks
        bases = [rng.standard_normal((3, 5)), rng.standard_normal(7),
                 rng.standard_normal(1)]
        dtypes = [torch.float32, torch.bfloat16, torch.float64]
        tree = [torch.as_tensor(b * (rank + 1)).to(d)
                for b, d in zip(bases, dtypes)]
        results = {}
        # ici level (reduce-scatter + all-gather, 23 elements padded to 24)
        # and the dcn level (one all-reduce), fused and per leaf
        for label, kw in [("ici", {"ici_group": dist.group.WORLD}),
                          ("dcn", {"dcn_group": dist.group.WORLD})]:
            for fuse in (True, False):
                out = tree_all_reduce(tree, average=False, fuse=fuse, **kw)
                results[f"{label}_sum_{fuse}"] = [o.double().numpy()
                                                  for o in out]
                assert [o.dtype for o in out] == dtypes
        mean = tree_all_reduce({"a": tree[0]}, ici_group=dist.group.WORLD)
        results["mean"] = mean["a"].numpy()
        bcast = tree_broadcast(tree, root=1, ici_group=dist.group.WORLD)
        results["bcast"] = [o.double().numpy() for o in bcast]
        # NaN on the other rank never reaches a broadcast's result
        poisoned = [t if rank == 1 else torch.full_like(t, float("nan"))
                    for t in tree]
        for label, kw in [("ici", {"ici_group": dist.group.WORLD}),
                          ("dcn", {"dcn_group": dist.group.WORLD})]:
            out = tree_broadcast(poisoned, root=1, **kw)
            results[f"bcast_nan_{label}"] = [o.double().numpy() for o in out]

        # a local group of 2 feeding the PS leg is a later slice
        os.environ["BYTEPS_PS_MODE"] = "ps"
        try:
            bps.init(device="cpu")
            raise AssertionError("PS mode with a local group of 2 started")
        except NotImplementedError as e:
            assert "multi-GPU-per-host PS" in str(e)

        # the collective train step on half batches vs one process
        os.environ["BYTEPS_PS_MODE"] = "collective"
        bps.init(device="cpu")
        assert (bps.rank(), bps.size(), bps.local_size()) == (rank, world,
                                                             world)
        cfg = dict(CFG, dtype=torch.float32, attn_impl="flash",
                   device="cpu")
        model = TransformerLM(
            **cfg, generator=torch.Generator().manual_seed(5 + rank))
        bps.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        step = make_train_step(_torch_loss, opt)
        tokens = torch.as_tensor(rng.integers(0, 64, size=(4, 16)))
        losses = [step(model, tokens[rank * 2:(rank + 1) * 2]).item()
                  for _ in range(2)]
        results["losses"] = losses
        results["params"] = {k: v.numpy().copy()
                             for k, v in model.state_dict().items()}
        results["tokens"] = tokens.numpy()
        bps.shutdown()
        torch.save(results, os.path.join(out_dir, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_two_process_gloo_collectives(tmp_path):
    mp.spawn(_gloo_worker, args=(2, _free_port(), str(tmp_path)), nprocs=2,
             join=True)
    r = [torch.load(tmp_path / f"r{i}.pt", weights_only=False)
         for i in range(2)]
    rng = np.random.default_rng(3)
    bases = [rng.standard_normal((3, 5)), rng.standard_normal(7),
             rng.standard_normal(1)]
    for i in range(2):
        for key in ("ici_sum_True", "ici_sum_False", "dcn_sum_True",
                    "dcn_sum_False"):
            for got, b, tol in zip(r[i][key], bases, (1e-6, 2e-2, 1e-12)):
                # bf16 leaves: each rank's input and the sum round to bf16
                np.testing.assert_allclose(got, 3 * b, rtol=tol, atol=tol,
                                           err_msg=key)
        np.testing.assert_allclose(r[i]["mean"], 1.5 * bases[0], rtol=1e-6)
        # a broadcast is exact: rank 1's leaves, bit for bit
        root_tree = [torch.as_tensor(2 * b).to(d).double().numpy()
                     for b, d in zip(bases, (torch.float32, torch.bfloat16,
                                             torch.float64))]
        for key in ("bcast", "bcast_nan_ici", "bcast_nan_dcn"):
            for got, want in zip(r[i][key], root_tree):
                np.testing.assert_array_equal(got, want, err_msg=key)
    # both ranks hold the same parameters, equal to one process on the
    # whole batch (SGD; summation order only)
    for k in r[0]["params"]:
        np.testing.assert_array_equal(r[0]["params"][k], r[1]["params"][k])
    ref = TransformerLM(**CFG, dtype=torch.float32, attn_impl="flash",
                        device="cpu",
                        generator=torch.Generator().manual_seed(5))
    opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    tokens = torch.as_tensor(r[0]["tokens"])
    ref_losses = []
    for _ in range(2):
        opt.zero_grad()
        loss = _torch_loss(ref, tokens)
        loss.backward()
        opt.step()
        ref_losses.append(loss.item())
    np.testing.assert_allclose(r[0]["losses"], ref_losses, rtol=1e-5)
    for k, v in ref.state_dict().items():
        np.testing.assert_allclose(r[0]["params"][k], v.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def _grid_worker(rank, world, port, out_dir):
    """Four processes as a 2 (dcn) x 2 (ici) grid: rank = ici + 2 * dcn."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        # every process creates every group, in the same order
        ici_groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        dcn_groups = [dist.new_group([0, 2]), dist.new_group([1, 3])]
        kw = dict(ici_group=ici_groups[rank // 2],
                  dcn_group=dcn_groups[rank % 2])
        results = {"bcast": []}
        for root in range(world):
            x = (torch.arange(5.0) + 10 * root if rank == root
                 else torch.full((5,), float("nan")))
            results["bcast"].append(tree_broadcast(x, root=root, **kw).numpy())
        base = np.random.default_rng(7).standard_normal(7)  # pads to 8
        x = torch.as_tensor(base * (rank + 1), dtype=torch.float64)
        results["sum"] = tree_all_reduce(x, average=False, **kw).numpy()
        results["mean"] = tree_all_reduce(x, **kw).numpy()
        torch.save(results, os.path.join(out_dir, f"g{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_two_level_grid_collectives(tmp_path):
    mp.spawn(_grid_worker, args=(4, _free_port(), str(tmp_path)), nprocs=4,
             join=True)
    base = np.random.default_rng(7).standard_normal(7)
    for i in range(4):
        r = torch.load(tmp_path / f"g{i}.pt", weights_only=False)
        for root, got in enumerate(r["bcast"]):
            np.testing.assert_array_equal(got, np.arange(5.0) + 10 * root)
        np.testing.assert_allclose(r["sum"], 10 * base, rtol=1e-12)
        np.testing.assert_allclose(r["mean"], 2.5 * base, rtol=1e-12)


# --- API contracts ------------------------------------------------------------

def test_api_before_init_raises():
    with pytest.raises(RuntimeError, match="init"):
        bps.rank()
    with pytest.raises(RuntimeError, match="init"):
        make_train_step(_torch_loss, None)


def test_init_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bps.init()
    bps.init(device="cpu")
    assert bps.device() == torch.device("cpu")
    assert (bps.rank(), bps.size(), bps.local_size()) == (0, 1, 1)


def test_push_pull_single_process_and_compression():
    bps.init(device="cpu")
    x = {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(0)),
         "b": torch.arange(5, dtype=torch.float32)}
    out = bps.push_pull(x)
    for k in x:
        torch.testing.assert_close(out[k], x[k])
    half = bps.push_pull(x, compression=Compression.bf16)
    assert half["w"].dtype == torch.float32
    torch.testing.assert_close(half["w"], x["w"].bfloat16().float())
    h = bps.push_pull_async([x["b"]])
    assert bps.poll(h)
    torch.testing.assert_close(bps.synchronize(h)[0], x["b"])


def test_distributed_optimizer_contract():
    bps.init(device="cpu")
    w = torch.nn.Parameter(torch.ones(3))
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        bps.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                 backward_passes_per_step=0)
    opt = bps.DistributedOptimizer(torch.optim.SGD([w], lr=0.5))
    (w * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    opt.step()
    torch.testing.assert_close(w.detach(), torch.tensor([0.5, 0.0, -0.5]))
    assert opt.param_groups[0]["lr"] == 0.5  # passes through
    opt.zero_grad()
    assert w.grad is None


def test_ps_mode_rejects_int8(monkeypatch):
    """The int8 transport has no PS counterpart: a ValueError, not a
    silent uncompressed f32 wire."""
    from byteps_tpu_torch.core import ffi

    monkeypatch.setenv("BYTEPS_PS_MODE", "ps")
    monkeypatch.setattr(ffi.Worker, "start", classmethod(
        lambda cls, cfg: type("Client", (), {"shutdown": lambda s: None})()))
    bps.init(device="cpu")
    int8 = Compressor("int8_quant", lambda x: x, lambda x, d: x.to(d))
    with pytest.raises(ValueError, match="int8"):
        make_train_step(_torch_loss, torch.optim.SGD(
            [torch.nn.Parameter(torch.ones(1))], lr=0.1), compression=int8)
