"""The C core's lossy codecs (onebit, topk, with error feedback) through
every PS path of the port, held to the JAX package's bridge.

Fast tests (``tests/ps_loopback.py`` stands in for the core's client and
records its declares): ``push_pull`` under the fleet default
(``BYTEPS_COMPRESSOR``) and under a codec that ``declare(name, ...,
compression_config=)`` sets for a name (``""`` turning it off), the
in-place calls' ``compression``, ``make_train_step``, the overlapped and
bucketed steps and the PS-mode ``DistributedOptimizer`` declare their
tensors with the codec, half leaves as f32 (the C codecs take f32), each
held to the declares of the JAX bridge (``ps._wire_plan``, ``_tids``,
``_TapState``) on the same leaves; the port's copy of the core encodes
and decodes as the JAX package's does, to the bit; the launcher hands
``BYTEPS_COMPRESSOR`` to every role it starts.

Fleet tests (``ps`` marker, outside the fast tier; the real C core, a
scheduler and one server on the CPU; workers in
``tests/_torch_codec_worker.py``):

- 2 workers: the plain, overlapped, bucketed and ``DistributedOptimizer``
  paths under onebit + EF and topk + EF against the JAX PS step in a
  fleet of its own. The model's gradient is its input (loss = sum of
  w * g), so SGD with lr 1 moves each parameter by the servers' mean,
  and every path's parameters after each step equal the JAX run's to the
  bit;
- two hosts of two ranks (the port's launcher, ``--workers-per-host
  2``) against the JAX controller of two chips: the plain step (whole
  leaves, the local mean) and the overlapped step (each rank's shard a
  tensor of its own, with its own error feedback), to the bit;
- the JAX contract of ``tests/test_examples.py``'s compression test
  through ``python -m byteps_tpu_torch.launcher --local 2 --num-servers
  1``: onebit + EF cuts both wire legs more than 8x, topk + EF the push
  leg more than 2x, the final losses are below 1.2, and each run's wire
  bytes are within 1 % of the JAX example's on the same settings.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import byteps_tpu_torch as bps  # noqa: E402
from byteps_tpu_torch.bucketed import make_bucketed_overlap_step  # noqa: E402
from byteps_tpu_torch.overlap import make_overlapped_train_step  # noqa: E402
from byteps_tpu_torch.training import make_train_step  # noqa: E402
from ps_loopback import LoopbackClient, init_loopback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ONEBIT = "type=onebit;ef=vanilla"
TOPK = "type=topk;k=24;ef=vanilla"


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.delenv("BYTEPS_COMPRESSOR", raising=False)
    yield
    if bps.initialized():
        bps.shutdown()
    torch.set_num_threads(threads)


def _leaves():
    """f32, bf16, f16 and int64 leaves, from a seed."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(40 * 3).astype(np.float32)
    return [torch.from_numpy(x).view(40, 3),
            torch.from_numpy(x[:17]).to(torch.bfloat16),
            torch.from_numpy(x[:5]).to(torch.float16),
            torch.arange(4, dtype=torch.int64)]


def _numpy(t):
    import ml_dtypes
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def _jax_tids(prefix, leaves, codec):
    """What the JAX bridge declares for ``leaves`` under ``prefix``."""
    from byteps_tpu.jax import ps as jps
    client = LoopbackClient()
    arrays = [_numpy(t) for t in leaves]
    jps._tid_cache.clear()
    jps._tids(client, prefix, arrays, jps._wire_plan(arrays, codec))
    jps._tid_cache.clear()
    return client.declares


@pytest.mark.parametrize("codec", [ONEBIT, TOPK])
def test_push_pull_under_the_fleet_codec_declares_as_the_jax_bridge(
        codec, monkeypatch):
    monkeypatch.setenv("BYTEPS_COMPRESSOR", codec)
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    leaves = _leaves()
    out = bps.push_pull(leaves, name="pp")
    assert client.declares == _jax_tids("pp", leaves, True)
    assert [d[2:] for d in client.declares] == [
        ("float32", None), ("float32", None), ("float32", None),
        ("int64", "")]
    for got, want in zip(out, leaves):  # one worker: the sum is the leaf
        assert got.dtype == want.dtype and torch.equal(got, want)
    # no codec: each leaf in its own dtype, inheriting the (empty) default
    bps.shutdown()
    monkeypatch.delenv("BYTEPS_COMPRESSOR")
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    bps.push_pull(leaves, name="plain")
    assert client.declares == _jax_tids("plain", leaves, False)


def test_declare_sets_a_codec_for_a_name(monkeypatch):
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    leaves = _leaves()
    bps.declare("named", leaves[0], compression_config=TOPK)
    bps.push_pull(leaves, name="named")
    assert [d[2:] for d in client.declares] == [
        ("float32", TOPK), ("float32", TOPK), ("float32", TOPK),
        ("int64", "")]
    # the same tree under a name without a codec: tensors of its own
    bps.push_pull(leaves, name="other")
    assert [d[2:] for d in client.declares[4:]] == [
        ("float32", None), ("bfloat16", None), ("float16", None),
        ("int64", None)]
    assert {d[0] for d in client.declares[:4]}.isdisjoint(
        d[0] for d in client.declares[4:])
    # the in-place calls take compression: a bf16 wire, declared f32
    # under the name's codec, and the sum written into the tensor
    x = torch.linspace(-1, 1, 9)
    bps.declare("inplace", x, compression_config=ONEBIT)
    y = x.clone()
    assert bps.push_pull_inplace_(y, name="inplace",
                                  compression=bps.Compression.bf16) is y
    assert client.declares[-1][1:] == (9, "float32", ONEBIT)
    assert torch.equal(y, x.to(torch.bfloat16).float())
    h = bps.push_pull_async_inplace_(x.clone(), name="inplace_fp16",
                                     compression=bps.Compression.fp16)
    assert torch.equal(bps.synchronize(h), x.to(torch.float16).float())
    assert client.declares[-1][1:] == (9, "float16", None)


def test_an_empty_codec_turns_the_fleet_default_off(monkeypatch):
    monkeypatch.setenv("BYTEPS_COMPRESSOR", ONEBIT)
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    leaves = _leaves()
    bps.push_pull(leaves, name="off")
    first = list(client.declares)
    bps.declare("off", leaves[0], compression_config="")
    bps.push_pull(leaves, name="off")
    # declared anew (fresh tensors), each leaf in its own dtype, no codec
    assert [d[2:] for d in client.declares[4:]] == [
        ("float32", ""), ("bfloat16", ""), ("float16", ""), ("int64", "")]
    assert {d[0] for d in first}.isdisjoint(d[0] for d in
                                            client.declares[4:])


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 3))


def _loss(model, x):
    return model(x).pow(2).sum()


def test_train_step_under_a_codec_declares_as_the_jax_ps_step(monkeypatch):
    """The plain step with the bf16 wire under the fleet codec: half
    leaves declared f32, the names the JAX PS step's (``_tids`` on the
    same leaves in the port's parameter order)."""
    monkeypatch.setenv("BYTEPS_COMPRESSOR", ONEBIT)
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    model = _model()
    step = make_train_step(_loss, torch.optim.SGD(model.parameters(),
                                                  lr=0.1),
                           compression=bps.Compression.bf16)
    step(model, torch.ones(4, 6))
    wires = [p.detach().to(torch.bfloat16) for p in model.parameters()]
    assert client.declares == _jax_tids("grad", wires, True)
    assert {d[2:] for d in client.declares} == {("float32", None)}
    assert len(client.pushes) == 4


# path -> (builder, wire, codec argument); the optimizer takes the fleet
# default, as the JAX DistributedOptimizer's tap state does
HOOK_PATHS = {
    "overlap_f32": ("overlap", "float32", TOPK),
    "overlap_bf16": ("overlap", "bfloat16", TOPK),
    "bucketed_multi": ("bucketed", "float32", ONEBIT),
    "bucketed_single_bf16": ("bucketed", "bfloat16", ONEBIT),
    "distributed_optimizer": ("optimizer", "float32", None),
    "distributed_optimizer_bf16": ("optimizer", "bfloat16", None),
}


@pytest.mark.parametrize("path", sorted(HOOK_PATHS))
def test_hook_paths_declare_the_codec_as_the_jax_tap_state(path,
                                                            monkeypatch):
    from byteps_tpu.jax.overlap import _TapState as JaxTapState
    kind, wire, codec = HOOK_PATHS[path]
    monkeypatch.setenv("BYTEPS_COMPRESSOR", TOPK)
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    model = _model()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    if kind == "overlap":
        step = make_overlapped_train_step(_loss, opt, prefix=path,
                                          wire_dtype=wire,
                                          compression_config=codec)
    elif kind == "bucketed":
        step = make_bucketed_overlap_step(
            _loss, opt, n_buckets=2, prefix=path, wire_dtype=wire,
            multi_program="single" not in path, compression_config=codec)
    else:
        compression = (bps.Compression.bf16 if wire == "bfloat16"
                       else bps.Compression.none)
        dopt = bps.DistributedOptimizer(
            opt, named_parameters=model.named_parameters(),
            compression=compression)
        path = "grad"

        def step(model, x):
            dopt.zero_grad()
            _loss(model, x).backward()
            dopt.step()
        step.close = dopt._taps.close
    before = [p.detach().clone() for p in model.parameters()]
    ref = _model()
    _loss(ref, torch.ones(4, 6)).backward()
    step(model, torch.ones(4, 6))
    step.close()
    jax_client = LoopbackClient()
    JaxTapState(jax_client, path, True, codec, 1,
                wire_dtype=wire).declare_all(
        [p.detach().numpy() for p in model.parameters()])
    assert client.declares == jax_client.declares
    assert {d[2:] for d in client.declares} == {("float32", codec)}
    # every push matched its declared dtype (the loopback checks it), and
    # the step applied the gradient it pushed: one worker, so the sum is
    # the gradient as the wire rounds it
    assert len(client.pushes) == 4
    dtype = torch.bfloat16 if wire == "bfloat16" else torch.float32
    for p, b, r in zip(model.parameters(), before, ref.parameters()):
        want = b.add(r.grad.to(dtype).float(), alpha=-0.1)
        torch.testing.assert_close(p.detach(), want, rtol=0, atol=0)


@pytest.mark.parametrize("config", [
    "type=onebit", ONEBIT, "type=topk", TOPK, "type=topk;k=5"])
def test_codec_roundtrip_equals_the_jax_packages_core(config):
    from byteps_tpu.core import ffi as jffi

    from byteps_tpu_torch.core import ffi
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(3000) * np.exp(rng.uniform(-4, 2, 3000))
         ).astype(np.float32)
    n, got = ffi.compressor_roundtrip(config, x)
    jn, want = jffi.compressor_roundtrip(config, x)
    assert n == jn > 0
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, x)  # lossy: the codec ran


def test_launcher_hands_the_codec_to_every_role(monkeypatch):
    from tests.test_torch_launcher import _Proc

    import byteps_tpu_torch.launcher.launch as launch
    spawned = []

    def popen(cmd, env=None, **kw):
        spawned.append(_Proc(cmd, env, 0))
        return spawned[-1]

    monkeypatch.setenv("DMLC_ROLE", "worker")
    monkeypatch.delenv("BYTEPS_LOCAL_SIZE", raising=False)
    monkeypatch.setenv("BYTEPS_COMPRESSOR", ONEBIT)
    monkeypatch.setattr(launch.subprocess, "Popen", popen)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    assert launch.main(["--local", "2", "--num-servers", "1", "--",
                        "train"]) == 0
    assert [p.env["DMLC_ROLE"] for p in spawned] == [
        "scheduler", "server", "worker", "worker"]
    assert all(p.env["BYTEPS_COMPRESSOR"] == ONEBIT for p in spawned)


# --- fleets ------------------------------------------------------------------

WORKER = os.path.join(HERE, "_torch_codec_worker.py")


def _run(procs, timeout):
    """Wait for every (name, Popen); raise with the failures' output."""
    failed, outs = [], {}
    try:
        for name, p in procs:
            outs[name], _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                failed.append(f"--- {name} exited {p.returncode} ---\n"
                              f"{outs[name]}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not failed, "\n".join(failed)
    return outs


def _popen(cmd, env):
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _fleet(kind, out_dir, codec, hosts=2, per_host=1, timeout=240):
    """A scheduler, one server and ``hosts`` workers of ``kind`` (the
    port's package or the JAX package's, each with its own server
    module); with ``per_host`` 2 each host is the port's launcher with
    ``--workers-per-host 2`` (port) or a controller of 2 chips (jax)."""
    from ps_utils import topology_env

    from byteps_tpu_torch.utils.ports import free_port

    package = "byteps_tpu_torch" if kind == "port" else "byteps_tpu"
    env = topology_env(hosts, 1, free_port(), {
        "BYTEPS_PS_MODE": "ps", "BYTEPS_COMPRESSOR": codec,
        "BYTEPS_SCHEDULING_CREDIT": str(1 << 30),
        "BYTEPS_LOCAL_STAGE_DIR": str(out_dir),
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={per_host}",
        "BPS_TEST_CHIPS": str(per_host), "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": HERE + os.pathsep + REPO})
    env.pop("BYTEPS_LOCAL_SIZE", None)
    procs = [(role, _popen([sys.executable, "-m", f"{package}.server"],
                           dict(env, DMLC_ROLE=role)))
             for role in ("scheduler", "server")]
    cmd = [sys.executable, WORKER, kind, str(out_dir)]
    if kind == "port" and per_host > 1:
        cmd = [sys.executable, "-m", "byteps_tpu_torch.launcher",
               "--workers-per-host", str(per_host), "--", *cmd]
    procs += [(f"host{h}", _popen(cmd, dict(
        env, DMLC_ROLE="worker", DMLC_WORKER_ID=str(h),
        BPS_TEST_LOCAL_PORT=str(free_port())))) for h in range(hosts)]
    return _run(procs, timeout)


def _assert_bitwise(port, jax, paths, ranks):
    import _torch_codec_worker as W
    for r in range(ranks):
        got = np.load(port / f"port_r{r}.npz")
        want = np.load(jax / f"jax_r{r // (ranks // 2)}.npz")
        for path, ref in paths.items():
            for t in range(W.STEPS):
                for n in W.SHAPES:
                    np.testing.assert_array_equal(
                        got[f"{path}/{t}/{n}"], want[f"{ref}/{t}/{n}"],
                        err_msg=f"rank {r} {path} step {t} {n}")
    # the codec ran: the first step is not the plain mean
    mean = sum(W.grads(0, r)["a"] for r in range(ranks)) / ranks
    assert not np.array_equal(got[f"{path}/0/a"], -mean)


@pytest.fixture(scope="module")
def built():
    from byteps_tpu_torch.core import build
    build.build(verbose=False)  # once, before the processes load it


@pytest.mark.ps
@pytest.mark.parametrize("codec", [ONEBIT, TOPK])
def test_every_path_sums_as_the_jax_ps_step(codec, tmp_path, built):
    import _torch_codec_worker as W
    port, jax = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax.mkdir()
    _fleet("port", port, codec)
    _fleet("jax", jax, codec)
    _assert_bitwise(port, jax, {p: "plain" for p in W.PATHS}, 2)


@pytest.mark.ps
def test_two_hosts_of_two_ranks_sum_as_the_jax_controllers(tmp_path,
                                                           built):
    port, jax = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax.mkdir()
    _fleet("port", port, ONEBIT, per_host=2)
    _fleet("jax", jax, ONEBIT, per_host=2)
    _assert_bitwise(port, jax, {"plain": "plain",
                                "overlap_f32": "overlap_f32"}, 4)
    assert not list(port.glob("bps_*"))  # no staging file left


# --- the JAX example's contract through the port's launcher ------------------

LM_STEPS = 25
LM_TOPK = "type=topk;k=4096;ef=vanilla"  # as tests/test_examples.py sizes it


def _results(text):
    dec = json.JSONDecoder()
    found, i = [], text.find("{")
    while i != -1:
        try:
            obj, end = dec.raw_decode(text, i)
        except json.JSONDecodeError:
            i = text.find("{", i + 1)
            continue
        if isinstance(obj, dict) and "final_loss" in obj:
            found.append(obj)
        i = text.find("{", end)
    assert found, f"no result JSON in output:\n{text}"
    return found


def _launched(cmd, codec, timeout=420):
    from byteps_tpu_torch.utils.ports import free_port
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + REPO,
               DMLC_PS_ROOT_PORT=str(free_port()), JAX_PLATFORMS="cpu",
               BYTEPS_COMPRESSOR=codec)
    env.pop("BYTEPS_LOCAL_SIZE", None)
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout + out.stderr
    return _results(out.stdout)


@pytest.mark.ps
def test_launched_lm_meets_the_jax_examples_contract(tmp_path, built):
    import jax

    from byteps_tpu.models.transformer import TransformerLM as FlaxLM
    from byteps_tpu_torch.models import from_flax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    fmodel = FlaxLM(num_layers=2, d_model=128, num_heads=4, mlp_dim=256,
                    vocab_size=512, max_len=64, dtype=jnp.float32)
    params = fmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64),
                                                          jnp.int32))
    torch.save(from_flax(jax.tree_util.tree_map(np.asarray, params)),
               tmp_path / "weights.pt")
    shim = ("import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
            "sys.argv = sys.argv[1:]; import runpy; "
            "runpy.run_path(sys.argv[0], run_name='__main__')")
    example = os.path.join(REPO, "example", "jax",
                           "train_gpt2_compression_byteps.py")
    port, ref = {}, {}
    for label, codec in (("base", ""), ("onebit", ONEBIT),
                         ("topk", LM_TOPK)):
        port[label] = _launched(
            [sys.executable, "-m", "byteps_tpu_torch.launcher", "--local",
             "2", "--num-servers", "1", "--", sys.executable, WORKER, "lm",
             str(tmp_path), str(LM_STEPS)], codec)
        ref[label] = _launched(
            [sys.executable, "-m", "byteps_tpu.launcher", "--local", "2",
             "--num-servers", "1", "--", sys.executable, "-c", shim,
             example, "--model", "tiny", "--steps", str(LM_STEPS),
             "--json"], codec)
        print(f"{label}: port {port[label]} jax {ref[label]}")
    for runs in (port, ref):
        assert all(len(r) == 2 for r in runs.values())
    base, onebit, topk = (port[k][0] for k in ("base", "onebit", "topk"))
    assert base["wire_sent_mb"] > 8 * onebit["wire_sent_mb"], (base, onebit)
    assert base["wire_recv_mb"] > 8 * onebit["wire_recv_mb"], (base, onebit)
    assert base["wire_sent_mb"] > 2 * topk["wire_sent_mb"], (base, topk)
    for label in port:
        for r in port[label]:
            assert r["final_loss"] < 1.2, (label, r)
        # every worker's bytes within 1 % of the JAX example's workers'
        for key in ("wire_sent_mb", "wire_recv_mb"):
            got = sorted(r[key] for r in port[label])
            want = sorted(r[key] for r in ref[label])
            for g, w in zip(got, want):
                assert abs(g - w) <= 0.01 * w, (label, key, got, want)
