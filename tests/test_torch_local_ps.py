"""PS mode with a local group: two gloo processes form one host, one core
client (local rank 0's) feeds the PS leg, every path of the port held to
the JAX package's 2-chip controller.

The world (``tests/_torch_local_ps_worker.py``, spawned once a session)
trains a narrow ``TransformerLM`` (2 layers, d 64, flash attention, whose
wrappers take their plain versions on the CPU) from the JAX model's
weights, each rank on its half of every batch, through every PS path:
the plain ``make_train_step`` (mean and sum), ``make_overlapped_train_step``
with the f32, bf16 and int8 wires (and f32 summed),
``make_bucketed_overlap_step`` (multi and single, and multi with the bf16
wire) and the PS-mode ``DistributedOptimizer`` (f32 and bf16). The root's
client is ``MirrorServer``: the core's client of one host of two whose
other host pushes what this one pushes, which keeps what was pushed and
writes the servers' result at the wait.

The reference is the JAX package's PS ``make_train_step`` on a 2-device
process-local mesh (``MeshSpec(dcn=1, ici=2)``, its flash attention in
interpret mode) over the same ``MirrorServer``, on the same batches: the
local pmean (psum for a sum) and the PS mean (sum) over the two hosts.
Each path's parameters and the mean of the two ranks' losses are held to
it within ``tests/wire_bound.py``'s bound (exact up to f32 rounding on an
f32 wire; within the wire's rounding of each step's mean gradient for
bf16 and int8, whose blocks are those of each leaf's shards), and the
f32 paths' parameters also to rtol 1e-4, atol 1e-6 as in
``test_torch_overlap.py``. The overlapped paths' declared tensors equal
the JAX ``_TapState``'s for the same leaves (names ``{prefix}_{i}.{j}``,
shard sizes with the int8 padding, dtypes), and the plain step's the JAX
PS step's (``ps._tids``, whole leaves).

The world also checks the roles (one client a host, rank and size by the
Horovod contract), the bytes each rank stages and the root pushes,
``push_pull``, ``broadcast_parameters`` from local rank 1, checkpoint
restore, the async step's refusal, ``push_pull_async`` beside a hooked
step (one order of the group's collectives on every rank) and the
BatchNorm step (equal to the bit in PS mode and collective mode). Two planted faults must fail the
parity, a rank that dies mid-step must make the survivor's wait name the
leaf and the rank, and no staging file may outlive the world. The
``-m ps`` test runs two hosts of two ranks each through the port's
launcher against one server with the real C core.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_local_ps_worker as W  # noqa: E402
from _torch_sp_worker import run_once  # noqa: E402
from wire_bound import (assert_near_reference, sgd_grads,  # noqa: E402
                        wire_error)

from byteps_tpu_torch.utils.ports import free_port  # noqa: E402

STEPS = 3
ROWS = 8  # a batch: 4 rows a rank


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(mode="parity", **extra):
    import jax
    import jax.numpy as jnp

    from byteps_tpu.models.transformer import TransformerLM as FlaxLM
    fmodel = FlaxLM(**W.CFG, dtype=jnp.float32, attn_impl="flash")
    params = jax.tree_util.tree_map(np.asarray, fmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, W.CFG["max_len"]), jnp.int32)))
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, W.CFG["vocab_size"],
                            size=(ROWS, W.CFG["max_len"]))
               for _ in range(STEPS)]
    return {"mode": mode, "params": params, "batches": batches, **extra}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_once(tmp_path_factory, "local_ps", _inputs,
                    W.local_ps_worker, world=2, timeout=300)


def _jax_run(inputs, average):
    """The JAX package's PS make_train_step on a 2-device mesh over a
    MirrorServer: (parameters before each step and after the last as
    float64 port state dicts, losses, the declares)."""
    import jax
    import jax.numpy as jnp
    import optax

    import byteps_tpu.jax as jbps
    from byteps_tpu.core import ffi as jffi
    from byteps_tpu.jax.training import make_train_step, replicate, shard_batch
    from byteps_tpu.models.transformer import TransformerLM as FlaxLM
    from byteps_tpu.models.transformer import lm_loss as jax_lm_loss
    from byteps_tpu.parallel.mesh import MeshSpec, build_mesh
    from byteps_tpu_torch.models import from_flax

    fmodel = FlaxLM(**W.CFG, dtype=jnp.float32, attn_impl="flash")

    def port(tree):
        return {k: v.to(torch.float64) for k, v in from_flax(
            jax.tree_util.tree_map(np.asarray, tree)).items()}

    client = W.MirrorServer()
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("BYTEPS_PS_MODE", "ps")
        mpatch.setattr(jffi.Worker, "start",
                       classmethod(lambda cls, cfg: client))
        mesh = build_mesh(MeshSpec(dcn=1, ici=2), devices=jax.devices()[:2])
        jbps.init(mesh=mesh)
        try:
            tx = optax.sgd(W.LR if average else W.LR / 4)
            jstep = make_train_step(
                lambda p, t: jax_lm_loss(fmodel.apply(p, t), t), tx, mesh,
                average=average, ps_prefix="plain" if average
                else "plain_sum")
            jp = replicate(jax.tree_util.tree_map(jnp.asarray,
                                                  inputs["params"]), mesh)
            js = replicate(tx.init(jp), mesh)
            snapshots, losses = [port(jp)], []
            for b in inputs["batches"]:
                jp, js, jl = jstep(jp, js, shard_batch(
                    jnp.asarray(b, jnp.int32), mesh))
                losses.append(float(jl))
                snapshots.append(port(jp))
        finally:
            jbps.shutdown()
    return snapshots, losses, client.declares


@pytest.fixture(scope="module")
def jax_reference(world):
    inputs = world[0]
    return {avg: _jax_run(inputs, avg) for avg in (True, False)}


def _blocks(state, wire):
    """Each parameter's int8 block on a host of two: the block of its
    shards, min(INT8_BLOCK, ceil(n / 2)) (1 for other wires)."""
    return {k: min(W.INT8_BLOCK, max(1, -(-v.size // 2)))
            if wire == "int8" else 1 for k, v in state.items()}


def _hold(label, wire, ranks, ref):
    """Both ranks' parameters and mean losses against the JAX run within
    ``wire``'s rounding; returns the shares of the bound taken."""
    snapshots, want_losses, _ = ref
    lr = W.LR if W.PATHS[label][2] else W.LR / 4
    grads = sgd_grads(snapshots, lr)
    blocks = _blocks(ranks[0]["state"], wire)
    errs = [{k: wire_error(wire, g, blocks[k]).reshape(g.shape)
             for k, g in step.items()} for step in grads]
    losses = [(a + b) / 2 for a, b in zip(ranks[0]["losses"],
                                          ranks[1]["losses"])]
    shares = []
    for r in ranks:
        shares.append(assert_near_reference(
            f"{label} rank", snapshots,
            {k: torch.from_numpy(v) for k, v in r["state"].items()}, lr,
            errs, [(t, a, b, grads[t]) for t, (a, b) in
                   enumerate(zip(losses, want_losses))]))
    return shares


WIRES = {"overlap_bf16": "bfloat16", "overlap_int8": "int8",
         "bucketed_multi_bf16": "bfloat16",
         "distributed_optimizer_bf16": "bfloat16"}


@pytest.mark.parametrize("path", sorted(W.PATHS))
def test_path_matches_jax_two_chip_controller(path, world, jax_reference):
    _, ranks = world
    got = [r["paths"][path] for r in ranks]
    ref = jax_reference[W.PATHS[path][2]]
    wire = WIRES.get(path, "float32")
    shares = _hold(path, wire, got, ref)
    print(f"{path}: share of the wire bound taken {shares}")
    if wire == "float32":
        for r in got:
            for k, v in r["state"].items():
                np.testing.assert_allclose(v, ref[0][-1][k].numpy(),
                                           rtol=1e-4, atol=1e-6, err_msg=k)
    # both ranks hold the same parameters, to the bit
    for k, v in got[0]["state"].items():
        np.testing.assert_array_equal(v, got[1]["state"][k], err_msg=k)


def _jax_tap_declares(path, leaves):
    """What the JAX package's ``_TapState`` of a 2-chip controller
    declares for ``leaves`` with ``path``'s wire."""
    from byteps_tpu.jax.overlap import _TapState as JaxTapState
    from ps_loopback import LoopbackClient
    kw = W.PATHS[path][1]
    client = LoopbackClient()
    JaxTapState(client, path, True, None, 2,
                wire_dtype=kw.get("wire_dtype", "float32"),
                wire_block=kw.get("wire_block", 256)).declare_all(leaves)
    return [d[:3] for d in client.declares]


@pytest.mark.parametrize("path", ["overlap_f32", "overlap_bf16",
                                  "overlap_int8"])
def test_overlap_declares_equal_the_jax_tap_state(path, world):
    _, ranks = world
    leaves = list(ranks[0]["paths"][path]["state"].values())
    got = [d[:3] for d in ranks[0]["paths"][path]["declares"]]
    assert got == _jax_tap_declares(path, leaves)
    assert ranks[1]["paths"][path]["declares"] == []


@pytest.mark.parametrize("average", [True, False])
def test_plain_step_declares_the_jax_ps_step_keys(average, world,
                                                  jax_reference):
    """Whole leaves under ``{prefix}_{crc:08x}_{i}``: the JAX step's
    leaves in its tree order, the port's in its parameter order, so the
    names are compared through the JAX bridge's ``_tids`` on the port's
    leaves."""
    from byteps_tpu.jax import ps as jps
    from ps_loopback import LoopbackClient
    _, ranks = world
    path = "plain" if average else "plain_sum"
    leaves = list(ranks[0]["paths"][path]["state"].values())
    client = LoopbackClient()
    jps._tid_cache.clear()
    jps._tids(client, path, leaves, jps._wire_plan(leaves, False))
    jps._tid_cache.clear()
    assert ranks[0]["paths"][path]["declares"] == client.declares
    # the JAX step itself declares as many whole leaves of the same sizes
    jax_declares = jax_reference[average][2]
    assert sorted(d[1] for d in jax_declares) == sorted(
        d[1] for d in client.declares)


def test_one_client_a_host_and_the_horovod_contract(world):
    _, ranks = world
    for r, rec in enumerate(ranks):
        assert rec["roles"] == {"started": [0] if r == 0 else [],
                                "rank": r, "size": 4, "local_rank": r,
                                "local_size": 2}
    # the other rank's client was never started, so never called
    assert ranks[1]["client_calls"] == (0, 0)
    assert ranks[0]["client_calls"][1] > 0


@pytest.mark.parametrize("path", sorted(W.PATHS))
def test_each_rank_stages_half_and_the_root_pushes_one_gradient(path,
                                                                world):
    _, ranks = world
    state = ranks[0]["paths"][path]["state"]
    kind, kw, _ = W.PATHS[path]
    wire = kw.get("wire_dtype", "float32")
    if kind == "optimizer" and kw.get("compression") == "bf16":
        wire = "bfloat16"
    blocks = _blocks(state, wire)
    shard = {k: -(-v.size // (2 * blocks[k])) * blocks[k]
             for k, v in state.items()}
    size = {"float32": 4, "bfloat16": 2, "int8": 1}[wire]
    staged = sum(n * size + (4 * n // blocks[k] if wire == "int8" else 0)
                 for k, n in shard.items())
    grad_bytes = sum(4 * v.size for v in state.values())
    summed = 4 if kind in ("overlap", "train_step") else size
    pushed = (grad_bytes if kind == "train_step"
              else sum(2 * n * summed for n in shard.values()))
    if kind == "train_step":  # whole leaves on the f32 wire
        staged = sum(4 * n for n in shard.values())
    for r, rec in enumerate(ranks):
        got = rec["paths"][path]
        assert got["d2h_bytes"] == [staged] * STEPS, (r, got["d2h_bytes"])
        assert got["pushed_bytes"] == [pushed if r == 0 else 0] * STEPS
    if wire == "float32":
        # half the gradient each, up to one element of padding a leaf
        assert grad_bytes / 2 <= staged <= grad_bytes / 2 + 4 * len(state)


def test_local_group_collectives(world):
    _, ranks = world
    for r, rec in enumerate(ranks):
        c = rec["checks"]
        # the local mean (1.5) averaged with the mirrored host
        assert c["mean"] == [1.5] * 5
        assert c["sum"] == [6.0] * 5  # (1 + 2) on each of two hosts
        assert c["tree"] == {"a": (torch.arange(12.0).view(3, 4) * 1.5
                                   ).tolist(), "b": [15.0] * 7}
        assert c["async"] == [6.0] * 5
        assert c["inplace_same"] and c["inplace"] == [1.5] * 5
        want = torch.tensor(0.5).to(torch.bfloat16).float().item()
        assert c["bf16"] == pytest.approx([want] * 5, rel=2 ** -8)
        assert "JAX package's async step" in c["async_refused"]
        assert "collective mode's transport" in c["int8_refused"]
        assert c["broadcast"] == {"w": [[1.0] * 5] * 3,
                                  "b": [100.0, 101.0, 102.0, 103.0]}
        assert c["restored"] == ((torch.arange(6.0) + 7).tolist(), 1)
        assert c["fleet_barriers"] == (1 if r == 0 else 0)
    # broadcast_optimizer_state through the three stages: rank 1, fresh,
    # holds the root's moments, step count and lr, its parameters unmoved
    o0, o1 = (rec["checks"]["opt_state"] for rec in ranks)
    assert o0["state"] == o1["state"] and len(o0["state"]) == 6
    assert [v for _, k, v in o1["state"] if k == "step"] == [1.0, 1.0]
    assert o0["lr"] == o1["lr"] == 1e-3
    assert o0["moved"] == o1["moved"] == [False, False]


def test_push_pull_async_beside_a_hooked_step(world):
    """A ``push_pull_async`` in flight while a hooked step's round issues
    the group's reduce-scatters, rank 1's bridge held back 0.3 s: both
    run on the bridge thread in the caller's order on every rank, so the
    metric is the ranks' mean and each path equals its run without the
    metric, to the bit (gloo would pair one rank's metric with the other
    rank's gradient otherwise, and hang or sum the wrong data)."""
    _, ranks = world
    for rec in ranks:
        for path, got in rec["concurrent"].items():
            assert got["metrics"] == [[t + 0.5] * 5 for t in range(STEPS)]
            for k, v in got["state"].items():
                np.testing.assert_array_equal(
                    v, rec["paths"][path]["state"][k], err_msg=f"{path} {k}")


def test_stateful_ps_step_equals_collective_with_a_local_group(world):
    """``stateful.py`` unchanged: its PS step over a local group of two
    (reduce-scatter, the root's push of the slices, all-gather, then the
    BatchNorm buffers averaged over the group) equals its collective
    step over the same group, to the bit."""
    _, ranks = world
    for rec in ranks:
        ps_state = rec["stateful_ps"][1]
        for k, v in rec["stateful_collective"][1].items():
            np.testing.assert_array_equal(ps_state[k], v, err_msg=k)
    # collective mode averages the loss over the group, PS mode keeps each
    # process's own
    mean = np.mean([r["stateful_ps"][0] for r in ranks], axis=0)
    np.testing.assert_allclose(ranks[0]["stateful_collective"][0], mean,
                               rtol=1e-7)
    for k, v in ranks[0]["stateful_ps"][1].items():
        np.testing.assert_array_equal(v, ranks[1]["stateful_ps"][1][k])


def test_no_staging_file_outlives_the_world(world):
    _, ranks = world
    assert [r["stage_left"] for r in ranks] == [[], []]


@pytest.mark.parametrize("fault", ["slices_swapped",
                                   "pushed_before_signal"])
def test_planted_fault_fails_the_parity(fault, tmp_path_factory,
                                        jax_reference):
    """Each rank's D2H written into the other's slice, or the root
    pushing a slice before its rank's signal (that rank's copy delayed
    50 ms): the summed f32 path no longer matches the JAX run."""
    inputs, ranks = run_once(tmp_path_factory, f"local_ps_{fault}",
                             lambda: _inputs(fault), W.local_ps_worker,
                             world=2, timeout=300)
    got = [r["paths"]["overlap_f32_sum"] for r in ranks]
    with pytest.raises(AssertionError, match="differ"):
        _hold("overlap_f32_sum", "float32", got, jax_reference[False])


def test_a_dead_rank_times_out_the_root_naming_the_leaf(tmp_path):
    """Rank 1 dies in the first overlapped step after copying its first
    shard and before signalling it: the root's wait for that shard times
    out (BYTEPS_TAP_TIMEOUT_S = 3) naming the leaf and the rank, its step
    raises, and no staging file is left."""
    torch.save(_inputs("death", timeout_s=3), tmp_path / "inputs.pt")
    ctx = mp.start_processes(W.dying_worker,
                             args=(2, free_port(), str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 180
    for p in ctx.processes:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    codes = [p.exitcode for p in ctx.processes]
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
    assert codes == [0, 3]
    rec = torch.load(tmp_path / "r0.pt", weights_only=False)
    # the last leaf in model order is reduced first
    assert rec["error"].startswith(
        "local rank 1's slice of final_ln.bias did not land in the shared "
        "staging for round 1 within BYTEPS_TAP_TIMEOUT_S (3 s)"), rec

    assert rec["stage_left"] == []


def test_resolve_device_maps_the_local_rank(monkeypatch):
    """BYTEPS_LOCAL_SIZE > 1: cuda:<BYTEPS_LOCAL_RANK>, which must exist;
    else the current device; an explicit device wins."""
    from byteps_tpu_torch._device import resolve_device
    monkeypatch.setenv("BYTEPS_LOCAL_SIZE", "2")
    monkeypatch.setenv("BYTEPS_LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_device() == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="cuda:1 does not exist"):
        resolve_device()
    monkeypatch.setenv("BYTEPS_LOCAL_SIZE", "1")
    assert resolve_device() == torch.device("cuda", 0)


def test_a_local_size_without_a_local_group_is_refused(monkeypatch):
    """BYTEPS_LOCAL_SIZE=2 in a process with no local group would start a
    client a process, not a host: refused, and no client started."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core import ffi
    monkeypatch.setenv("BYTEPS_PS_MODE", "ps")
    monkeypatch.setenv("BYTEPS_LOCAL_SIZE", "2")
    started = []
    monkeypatch.setattr(ffi.Worker, "start", classmethod(
        lambda cls, cfg: started.append(cfg)))
    with pytest.raises(ValueError, match="has no local group"):
        bps.init(device="cpu")
    assert started == [] and not bps.initialized()


@pytest.mark.ps
def test_fleet_two_hosts_of_two_ranks_match_one_process(tmp_path):
    """A scheduler, one server (the real C core) and two hosts, each the
    port's launcher with ``--workers-per-host 2`` over a gloo group of its
    own: every rank's plain and overlapped steps equal one process on the
    whole batches (rtol 1e-5), the counterpart of ``tests/test_ps_core.py``'s
    ``test_jax_overlapped_training_multichip_controller``; no staging file
    is left."""
    from ps_utils import topology_env

    from byteps_tpu_torch.core import build
    build.build(verbose=False)  # once, before the processes load it
    stage = tmp_path / "stage"
    stage.mkdir()
    env = topology_env(2, 1, free_port(), {
        "BYTEPS_PS_MODE": "ps", "BYTEPS_LOCAL_STAGE_DIR": str(stage),
        "BYTEPS_SCHEDULING_CREDIT": str(1 << 30)})
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_torch_local_ps_worker.py")
    procs = [(role, subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.server"],
        env=dict(env, DMLC_ROLE=role), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for role in ("scheduler", "server")]
    procs += [(f"host{h}", subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.launcher",
         "--workers-per-host", "2", "--", sys.executable, worker],
        env=dict(env, DMLC_ROLE="worker", DMLC_WORKER_ID=str(h),
                 BPS_TEST_LOCAL_PORT=str(free_port()),
                 PYTHONPATH=os.path.dirname(worker) + os.pathsep
                 + env["PYTHONPATH"]),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for h in range(2)]
    failed, outs = [], {}
    try:
        for name, p in procs:
            outs[name], _ = p.communicate(timeout=300)
            if p.returncode != 0:
                failed.append(f"--- {name} exited {p.returncode} ---\n"
                              f"{outs[name]}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not failed, "\n".join(failed)
    oks = "".join(outs[f"host{h}"] for h in range(2))
    assert sorted(r for r in range(4)
                  if f"rank {r}: local PS fleet OK" in oks) == [0, 1, 2, 3]
    assert list(stage.iterdir()) == []
