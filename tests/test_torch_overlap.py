"""The port's overlapped PS steps: ``make_overlapped_train_step``,
``make_bucketed_overlap_step`` and the PS-mode ``DistributedOptimizer``.

Fast tests need no fleet: the C client is replaced by a loopback stand-in
(``tests/ps_loopback.py``; one worker, so a push_pull's sum is the array
itself) that records declares, pushes and waits. The model is a small
``TransformerLM`` (2 layers, d 32, f32, flash attention, whose wrappers
take their plain versions on the CPU) with the JAX model's weights
(``from_flax``); the JAX package's functions run on the same numpy
inputs. Tolerances: every path's losses and parameter changes are held to
the JAX run by ``tests/wire_bound.py``: exact up to f32 rounding for an
f32 wire (losses rtol 1e-5, and the parameters also to
``test_collective_step_matches_jax_mesh``'s rtol 1e-4, atol 1e-6), within
the wire's own rounding of each step's gradient for bf16, f16 and int8
(2^-8 and 2^-11 of each element, half an int8 step of its block).

Accumulation with a lossy wire: the port accumulates the f32 ``.grad`` of
K passes on the card and casts the sum once; the JAX module casts each
pass and sums the wires on the host. In f32 the two are the same; with
bf16 or int8 they differ within the wire's tolerance.

Fleet tests (``ps`` marker, outside the fast tier): 2 workers x 1 server
on the CPU, the counterparts of ``tests/test_ps_core.py``'s overlap tests;
run as a script, this file is such a worker.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import byteps_tpu_torch as bps  # noqa: E402
from byteps_tpu_torch import ps  # noqa: E402
from byteps_tpu_torch.bucketed import (  # noqa: E402
    make_bucketed_overlap_step, partition_buckets)
from byteps_tpu_torch.models.transformer import (TransformerLM,  # noqa: E402
                                                 from_flax, lm_loss)
from byteps_tpu_torch.overlap import make_overlapped_train_step  # noqa: E402
from byteps_tpu_torch.parallel.hierarchical import (  # noqa: E402
    _blockwise_dequantize, _blockwise_quantize)
from ps_loopback import LoopbackClient, init_loopback  # noqa: E402
from wire_bound import (assert_near_reference, sgd_grads,  # noqa: E402
                        snapshot, wire_error, wire_errors)

CFG = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, mlp_dim=64,
           max_len=16)
LR = 0.1
STEPS = 3
INT8_BLOCK = 48  # does not divide the leaves: the pad is exercised
# path -> (wire, dtype the servers sum, builder keyword arguments)
PATHS = {
    "overlap_f32": ("float32", "float32", {}),
    "overlap_bf16": ("bfloat16", "float32", {"wire_dtype": "bfloat16"}),
    "overlap_int8": ("int8", "float32",
                     {"wire_dtype": "int8", "wire_block": INT8_BLOCK}),
    "bucketed_multi": ("float32", "float32", {"multi_program": True}),
    "bucketed_single": ("float32", "float32", {"multi_program": False}),
    "bucketed_multi_bf16": ("bfloat16", "bfloat16",
                            {"multi_program": True,
                             "wire_dtype": "bfloat16"}),
    "bucketed_single_bf16": ("bfloat16", "bfloat16",
                             {"multi_program": False,
                              "wire_dtype": "bfloat16"}),
    "distributed_optimizer": ("float32", "float32", {}),
    "distributed_optimizer_bf16": ("bfloat16", "bfloat16",
                                   {"compression": bps.Compression.bf16}),
    "distributed_optimizer_fp16": ("float16", "float16",
                                   {"compression": bps.Compression.fp16}),
}


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    # One intra-op thread: the models are tiny, and the other test
    # workers on this host need the cores more than these tests do.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("BYTEPS_PS_MODE", "collective")
    yield
    if bps.initialized():
        bps.shutdown()
    torch.set_num_threads(threads)


def _loss(model, tokens):
    return lm_loss(model(tokens), tokens)


def _batches(n, seed=7, rows=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], size=(rows, CFG["max_len"]))
            for _ in range(n)]


def _flax_params():
    import jax
    import jax.numpy as jnp

    from byteps_tpu.models.transformer import TransformerLM as FlaxLM
    fmodel = FlaxLM(**CFG, dtype=jnp.float32)
    params = fmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, CFG["max_len"]), jnp.int32))
    return fmodel, jax.tree_util.tree_map(np.asarray, params)


def _model(params=None):
    model = TransformerLM(**CFG, dtype=torch.float32, attn_impl="flash",
                          device="cpu")
    model.load_state_dict(from_flax(params or _flax_params()[1]))
    return model


def _sgd_step(path, model, opt, **kw):
    """The port's step for ``path``: step(model, tokens) -> loss."""
    if path.startswith("overlap"):
        return make_overlapped_train_step(_loss, opt, **kw)
    if path.startswith("bucketed"):
        return make_bucketed_overlap_step(_loss, opt, n_buckets=3, **kw)
    dopt = bps.DistributedOptimizer(opt, **kw)

    def step(model, tokens):
        dopt.zero_grad()
        loss = _loss(model, tokens)
        loss.backward()
        dopt.step()
        return loss.detach()
    step.opt = dopt
    step.close = dopt._taps.close
    return step


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's make_train_step (collective, SGD) on a one-device
    mesh over the same batches: the parameters before each step and after
    the last (as the port's state dicts, float64) and the losses."""
    import jax
    import jax.numpy as jnp
    import optax

    import byteps_tpu.jax as jbps
    from byteps_tpu.jax.training import make_train_step, replicate, shard_batch
    from byteps_tpu.models.transformer import lm_loss as jax_lm_loss
    from byteps_tpu.parallel.mesh import MeshSpec, build_mesh

    fmodel, params = _flax_params()

    def port(tree):
        return {k: v.to(torch.float64) for k, v in from_flax(
            jax.tree_util.tree_map(np.asarray, tree)).items()}

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BYTEPS_PS_MODE", "collective")
        mesh = build_mesh(MeshSpec(dcn=1, ici=1), devices=jax.devices()[:1])
        jbps.init(mesh=mesh)
        try:
            tx = optax.sgd(LR)
            jstep = make_train_step(
                lambda p, t: jax_lm_loss(fmodel.apply(p, t), t), tx, mesh)
            jp = replicate(jax.tree_util.tree_map(jnp.asarray, params), mesh)
            js = replicate(tx.init(jp), mesh)
            snapshots, losses = [port(jp)], []
            for b in _batches(STEPS):
                jp, js, jl = jstep(jp, js, shard_batch(
                    jnp.asarray(b, jnp.int32), mesh))
                losses.append(float(jl))
                snapshots.append(port(jp))
        finally:
            jbps.shutdown()
    return params, losses, snapshots


def _hold_to_jax(label, wire, model, losses, jax_reference):
    """``model`` after STEPS steps and their ``losses`` against the JAX
    run, within ``wire``'s rounding (``tests/wire_bound.py``)."""
    _, want_losses, snapshots = jax_reference
    grads = sgd_grads(snapshots, LR)
    return assert_near_reference(
        label, snapshots, model.state_dict(), LR,
        wire_errors(wire, grads, INT8_BLOCK),
        [(t, a, b, grads[t]) for t, (a, b) in enumerate(zip(losses,
                                                             want_losses))])


@pytest.mark.parametrize("path", sorted(PATHS))
def test_path_matches_jax_train_step(path, monkeypatch, jax_reference):
    params, _, snapshots = jax_reference
    wire, summed, kw = PATHS[path]
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    model = _model(params)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    step = _sgd_step(path, model, opt, **kw)
    losses = [step(model, torch.as_tensor(b)).item()
              for b in _batches(STEPS)]
    shares = _hold_to_jax(path, wire, model, losses, jax_reference)
    print(f"{path}: share of the wire bound taken, losses {shares[0]:.3f}, "
          f"parameters {shares[1]:.3f}")
    if wire == "float32":
        for k, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), snapshots[-1][k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    # what the servers sum: f32, or the half wire as it is
    assert {d[2] for d in client.declares} == {summed}
    n = len(list(model.parameters()))
    assert sorted(client.pushes) == sorted(list(range(n)) * STEPS)
    # every push comes from the stager thread, not from autograd's hooks
    # (bucketed single pushes from the step itself, after backward)
    if not path.startswith("bucketed_single"):
        assert all(t.startswith("bps_stager")
                   for t in client.push_threads), set(client.push_threads)
    step.close()


def _zero_leaf(monkeypatch, tid):
    """A wire that pushes zeros for tensor ``tid``."""
    push = ps.push_host

    def zeroed(client, t, buf, average):
        if t == tid:
            buf.zero_()
        return push(client, t, buf, average)
    monkeypatch.setattr(ps, "push_host", zeroed)


def _double_scale(monkeypatch):
    """An int8 wire whose block scales come out twice too large."""
    import byteps_tpu_torch.overlap as overlap

    def doubled(x, block):
        q, scale = _blockwise_quantize(x, block)
        return q, scale * 2
    monkeypatch.setattr(overlap, "_blockwise_quantize", doubled)


def _halve_expansion(monkeypatch):
    """A host re-expansion of the bf16 wire that loses a factor of 2."""
    from byteps_tpu_torch.overlap import _TapState
    push_shard = _TapState.push_shard

    def halved(self, idx):
        self.wire_bufs[idx][0].mul_(0.5)
        push_shard(self, idx)
    monkeypatch.setattr(_TapState, "push_shard", halved)


@pytest.mark.parametrize("path,fault", [
    ("overlap_int8", "doubled_scale"), ("overlap_int8", "zeroed_leaf"),
    ("overlap_bf16", "zeroed_leaf"), ("overlap_bf16", "halved_expansion"),
    ("distributed_optimizer_bf16", "zeroed_leaf"),
    ("bucketed_multi_bf16", "zeroed_leaf")])
def test_wire_bound_fails_a_planted_fault(path, fault, monkeypatch,
                                          jax_reference):
    """The bound of ``test_path_matches_jax_train_step`` is tight enough
    to catch a broken wire: one leaf pushed as zeros (the last layer's
    first MLP kernel; declared tensor ids follow the parameters), int8
    scales twice too large, a host re-expansion that halves the wire."""
    params = jax_reference[0]
    wire, _, kw = PATHS[path]
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    model = _model(params)
    names = [n for n, _ in model.named_parameters()]
    {"zeroed_leaf": lambda: _zero_leaf(
        monkeypatch, names.index("layers.1.mlp_in.kernel")),
     "doubled_scale": lambda: _double_scale(monkeypatch),
     "halved_expansion": lambda: _halve_expansion(monkeypatch)}[fault]()
    step = _sgd_step(path, model, torch.optim.SGD(model.parameters(),
                                                  lr=LR), **kw)
    losses = [step(model, torch.as_tensor(b)).item()
              for b in _batches(STEPS)]
    step.close()
    with pytest.raises(AssertionError, match="differ"):
        _hold_to_jax(path, wire, model, losses, jax_reference)


def test_distributed_optimizer_half_wire_is_summed_in_f32_under_a_codec(
        monkeypatch):
    """With a fleet-wide codec (f32-domain in the C core) the bf16
    compression is declared f32, re-expanded on the host, as ``push_pull``
    declares it then (``ps._wire_plan``): the step equals plain SGD on the
    bf16-rounded gradients, bit for bit."""
    monkeypatch.setenv("BYTEPS_COMPRESSOR", "type=onebit")
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    params = _flax_params()[1]
    tokens = torch.as_tensor(_batches(1)[0])
    model, ref = _model(params), _model(params)
    step = _sgd_step("distributed_optimizer_bf16", model,
                     torch.optim.SGD(model.parameters(), lr=LR),
                     compression=bps.Compression.bf16)
    step(model, tokens)
    step.close()
    assert {d[2] for d in client.declares} == {"float32"}
    _loss(ref, tokens).backward()
    for p in ref.parameters():
        p.grad = p.grad.to(torch.bfloat16).float()
    torch.optim.SGD(ref.parameters(), lr=LR).step()
    for (k, a), b in zip(model.state_dict().items(),
                         ref.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_overlap_declares_in_model_order_and_pushes_in_backward_order(
        monkeypatch):
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    params = _flax_params()[1]
    tokens = torch.as_tensor(_batches(1)[0])
    # backward order, read from hooks on a plain model of the same shape
    ref, order = _model(params), []
    for i, p in enumerate(ref.parameters()):
        p.register_post_accumulate_grad_hook(
            lambda p, i=i: order.append(i))
    _loss(ref, tokens).backward()
    model = _model(params)
    step = make_overlapped_train_step(
        _loss, torch.optim.SGD(model.parameters(), lr=LR), prefix="tap")
    assert client.declares == [(f"tap_{i}.0", p.numel(), "float32", None)
                               for i, p in enumerate(model.parameters())]
    for _ in range(2):
        first = len(client.pushes)
        step(model, tokens)
        assert client.pushes[first:] == order  # once each, back to front
    # the tied embedding, first in model order, is used by the first
    # forward op: its hook fires last
    assert order[-1] == 0 and order != sorted(order)
    t = step.timings
    assert t["start"] < t["backward"] <= t["landed"]
    assert len(t["pushes"]) == len(order)


def test_overlap_accumulation_matches_one_full_batch_step(monkeypatch):
    """backward_passes_per_step=3 (mirrors ``_ps_worker.py``'s
    jax_overlap_accum): the non-final calls leave the parameters as they
    are and push nothing; the final call equals one SGD step at lr on the
    mean of the three microbatch losses (the caller divides by K: SGD at
    lr / K on the summed gradients)."""
    import jax
    import jax.numpy as jnp

    from byteps_tpu.models.transformer import lm_loss as jax_lm_loss
    k, lr = 3, 0.3
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    fmodel, params = _flax_params()
    micro = _batches(k, seed=11, rows=4)
    model = _model(params)
    step = make_overlapped_train_step(
        _loss, torch.optim.SGD(model.parameters(), lr=lr / k),
        backward_passes_per_step=k)
    for m, b in enumerate(micro):
        before = {n: p.clone() for n, p in model.state_dict().items()}
        step(model, torch.as_tensor(b))
        if m < k - 1:
            assert client.pushes == []
            for n, p in model.state_dict().items():
                torch.testing.assert_close(p, before[n], rtol=0, atol=0)
    n_params = len(list(model.parameters()))
    assert sorted(client.pushes) == list(range(n_params))

    def full_loss(p):
        return sum(jax_lm_loss(fmodel.apply(p, jnp.asarray(b, jnp.int32)),
                               jnp.asarray(b, jnp.int32))
                   for b in micro) / k

    g = jax.grad(full_loss)(jax.tree_util.tree_map(jnp.asarray, params))
    want = from_flax(jax.tree_util.tree_map(
        lambda p, g: np.asarray(p - lr * g), params, g))
    for n, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=n)


@pytest.mark.parametrize("path", ["overlap_bf16", "bucketed_multi"])
def test_hooks_and_stager_under_a_short_switch_interval(monkeypatch, path):
    """The hooks (autograd's thread) and the stager share the staged
    queue, the in-flight table and the timeline. With the interpreter
    switching threads every microsecond, every leaf is still pushed once a
    step and the parameters equal the same steps run again the same way
    (bit for bit: a lost or doubled gradient would show)."""
    params = _flax_params()[1]
    batches = _batches(8, seed=5, rows=2)
    results = []
    old = sys.getswitchinterval()
    try:
        for interval in (old, 1e-6):
            sys.setswitchinterval(interval)
            client = LoopbackClient()
            init_loopback(monkeypatch, client)
            model = _model(params)
            step = _sgd_step(path, model,
                             torch.optim.SGD(model.parameters(), lr=LR),
                             **PATHS[path][2])
            t0 = time.monotonic()
            for b in batches:
                step(model, torch.as_tensor(b))
            assert time.monotonic() - t0 < 120
            n = len(list(model.parameters()))
            assert sorted(client.pushes) == sorted(list(range(n))
                                                   * len(batches))
            results.append(model.state_dict())
            step.close()
            bps.shutdown()
    finally:
        sys.setswitchinterval(old)
    for k, v in results[0].items():
        torch.testing.assert_close(results[1][k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("multi", [True, False])
def test_bucketed_pushes_buckets_last_first(monkeypatch, multi):
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    model = _model()
    params = list(model.parameters())
    buckets = partition_buckets([p.numel() * 4 for p in params], 3)
    assert len(buckets) == 3
    step = make_bucketed_overlap_step(
        _loss, torch.optim.SGD(params, lr=LR), n_buckets=3,
        multi_program=multi, prefix="bk")
    assert [d[0] for d in client.declares] == [f"bk_{i}.0"
                                               for i in range(len(params))]
    step(model, torch.as_tensor(_batches(1)[0]))
    # whole buckets, last first, each in model order
    assert client.pushes == [i for b in reversed(buckets) for i in b]


@pytest.mark.parametrize("programs", ["multi", "single"])
def test_bucketed_reads_its_environment_defaults(monkeypatch, programs):
    """``BYTEPS_OVERLAP_BUCKETS`` sets the bucket count and
    ``BYTEPS_BUCKET_PROGRAMS`` the mode: the hooks' stager pushes in
    ``multi``, the step itself after backward in ``single``."""
    monkeypatch.setenv("BYTEPS_OVERLAP_BUCKETS", "2")
    monkeypatch.setenv("BYTEPS_BUCKET_PROGRAMS", programs)
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    model = _model()
    params = list(model.parameters())
    buckets = partition_buckets([p.numel() * 4 for p in params], 2)
    assert len(buckets) == 2
    step = make_bucketed_overlap_step(_loss,
                                      torch.optim.SGD(params, lr=LR))
    step(model, torch.as_tensor(_batches(1)[0]))
    step.close()
    assert client.pushes == [i for b in reversed(buckets) for i in b]
    stager = {t.startswith("bps_stager") for t in client.push_threads}
    assert stager == {programs == "multi"}


def test_distributed_optimizer_pushes_from_hooks_before_step(monkeypatch):
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    params = _flax_params()[1]
    tokens = torch.as_tensor(_batches(1)[0])
    model, ref = _model(params), _model(params)
    opt = bps.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR))
    n = len(list(model.parameters()))
    assert [d[0] for d in client.declares] == [f"grad_{i}.0"
                                               for i in range(n)]
    _loss(model, tokens).backward()
    opt._taps.stager.join()  # what the hooks queued has been pushed
    assert sorted(client.pushes) == list(range(n))
    assert client.waited == []
    opt.step()
    assert sorted(client.waited) == list(range(n))
    ref_opt = torch.optim.SGD(ref.parameters(), lr=LR)
    _loss(ref, tokens).backward()
    ref_opt.step()
    for (k, a), b in zip(model.state_dict().items(),
                         ref.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("path", ["overlap_f32", "bucketed_multi",
                                  "bucketed_single", "distributed_optimizer"])
def test_failed_wait_settles_every_handle_then_next_step_is_clean(
        monkeypatch, path):
    """The core fails one handle: every other handle of the step is still
    waited (the core pulls into the host buffers in place), the error is
    raised, the parameters are left as they were, and the next step runs
    clean and equals one plain SGD step."""
    params = _flax_params()[1]
    tokens = torch.as_tensor(_batches(1)[0])
    model, ref = _model(params), _model(params)
    n = len(list(model.parameters()))
    client = LoopbackClient(fail=lambda h, tid: h < n and tid == 3)
    init_loopback(monkeypatch, client)
    step = _sgd_step(path, model,
                     torch.optim.SGD(model.parameters(), lr=LR),
                     **PATHS[path][2])
    with pytest.raises(RuntimeError, match="loopback failure of tensor 3"):
        step(model, tokens)
    assert set(client.waited) == set(range(n))
    for (k, a), b in zip(model.state_dict().items(),
                         ref.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    step(model, tokens)
    ref_opt = torch.optim.SGD(ref.parameters(), lr=LR)
    _loss(ref, tokens).backward()
    ref_opt.step()
    for (k, a), b in zip(model.state_dict().items(),
                         ref.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("path", ["overlap_f32", "bucketed_multi",
                                  "bucketed_single"])
def test_backward_that_fails_midway_leaves_the_next_step_clean(monkeypatch,
                                                               path):
    """A backward that raises after some hooks fired (here a hook of the
    caller's, on the first layer's MLP kernel) raises from the step; the
    next step pushes each leaf once, with none of the failed step's
    staged gradients, and equals one plain SGD step."""
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    params = _flax_params()[1]
    tokens = torch.as_tensor(_batches(1)[0])
    model, ref = _model(params), _model(params)
    step = _sgd_step(path, model,
                     torch.optim.SGD(model.parameters(), lr=LR),
                     **PATHS[path][2])
    armed = [True]

    def planted(p):
        if armed[0]:
            armed[0] = False
            raise RuntimeError("planted backward failure")
    dict(model.named_parameters())[
        "layers.0.mlp_in.kernel"].register_post_accumulate_grad_hook(planted)
    with pytest.raises(RuntimeError, match="planted backward failure"):
        step(model, tokens)
    first = len(client.pushes)
    step(model, tokens)
    assert sorted(client.pushes[first:]) == list(
        range(len(list(model.parameters()))))
    ref_opt = torch.optim.SGD(ref.parameters(), lr=LR)
    _loss(ref, tokens).backward()
    ref_opt.step()
    for (k, a), b in zip(model.state_dict().items(),
                         ref.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("path", ["overlap_f32", "bucketed_multi",
                                  "bucketed_single", "distributed_optimizer"])
def test_parameter_without_gradient_raises_at_once(monkeypatch, path):
    """A parameter that gets no gradient never fires its hook; the step
    names it when backward returns instead of waiting out the tap
    timeout."""
    client = LoopbackClient()
    init_loopback(monkeypatch, client)
    monkeypatch.setenv("BYTEPS_TAP_TIMEOUT_S", "600")
    model = _model()
    model.unused = torch.nn.Linear(2, 3, bias=False)
    step = _sgd_step(path, model,
                     torch.optim.SGD(model.parameters(), lr=LR),
                     **PATHS[path][2])
    t0 = time.monotonic()
    # the step builders know the model; the optimizer wrapper does not
    name = (r"#\d+ \[3, 2\]" if path == "distributed_optimizer"
            else "unused.weight")
    with pytest.raises(RuntimeError,
                       match=rf"no gradient reached parameter\(s\) {name}"):
        step(model, torch.as_tensor(_batches(1)[0]))
    assert time.monotonic() - t0 < 60


# --- pieces held against the JAX package's functions ------------------------

_rng = np.random.default_rng(11)
PARTITION_CASES = [
    # tests/test_partition.py's cases
    ([100] * 8, 4), ([4096, 8, 8, 8, 8, 8, 8, 8], 4), ([5], 4),
    ([5, 5], 1), ([1] * 3, 8),
] + [
    # seeded random size lists: skewed sizes, more or fewer buckets
    (_rng.integers(1, 10 ** int(_rng.integers(1, 7)),
                   size=int(_rng.integers(1, 60))).tolist(),
     int(_rng.integers(1, 12)))
    for _ in range(8)
]


@pytest.mark.parametrize("sizes,n_buckets", PARTITION_CASES)
def test_partition_buckets_matches_jax(sizes, n_buckets):
    from byteps_tpu.jax.bucketed import partition_buckets as jax_partition
    got = partition_buckets(sizes, n_buckets)
    assert got == jax_partition(sizes, n_buckets)
    assert [i for b in got for i in b] == list(range(len(sizes)))


@pytest.mark.parametrize("block", [1, 3, 48, 256])
def test_blockwise_quantize_matches_jax_bit_for_bit(block):
    import jax.numpy as jnp

    from byteps_tpu.parallel.hierarchical import (
        _blockwise_dequantize as jax_dequantize)
    from byteps_tpu.parallel.hierarchical import (
        _blockwise_quantize as jax_quantize)
    rng = np.random.default_rng(block)
    x = (rng.standard_normal(block * 40)
         * np.exp(rng.uniform(-20, 5, block * 40))).astype(np.float32)
    x[:block] = 0.0  # a zero block: scale 0, codes 0
    x[block:2 * block] = np.arange(block) * 0.5  # ties round half to even
    q, s = _blockwise_quantize(torch.from_numpy(x), block)
    jq, js = jax_quantize(jnp.asarray(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_blockwise_dequantize(q, s).numpy(),
                                  np.asarray(jax_dequantize(jq, js)))
    assert not s[0].item() and not q[0].any()


# --- the fleet ---------------------------------------------------------------

FLEET_MODES = ["overlap_f32", "overlap_bf16", "overlap_int8", "accum",
               "bucketed_multi", "bucketed_single"]


@pytest.mark.ps
@pytest.mark.parametrize("mode", FLEET_MODES)
def test_fleet_two_workers_match_single_process(mode):
    """2 workers x 1 server on the CPU; each worker trains on its half of
    every batch, and the result must equal one process on the whole
    batch."""
    import subprocess

    from ps_utils import spawn_worker, topology_env

    from byteps_tpu_torch.core import build
    from byteps_tpu_torch.utils.ports import free_port
    build.build(verbose=False)  # once, before the processes load it
    env = topology_env(2, 1, free_port(), {"BYTEPS_PS_MODE": "ps"})
    procs = [(role, subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.server"],
        env=dict(env, DMLC_ROLE=role), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for role in ("scheduler", "server")]
    procs += [(f"worker{r}", spawn_worker(os.path.abspath(__file__), env, r,
                                          mode=mode))
              for r in range(2)]
    failed = []
    try:
        for name, p in procs:
            out, _ = p.communicate(timeout=240)
            if p.returncode != 0:
                failed.append(f"--- {name} exited {p.returncode} ---\n{out}")
            elif name.startswith("worker"):
                assert f"{mode} OK" in out, out
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not failed, "\n".join(failed)


def _worker_main(mode: str) -> int:
    """One fleet worker: SGD on this worker's half of each batch through
    ``mode``'s step, held to one process on the whole batches within the
    wire's rounding (``tests/wire_bound.py``): the reference takes each
    worker's half gradient apart, so the bound is the mean of the two
    workers' wire errors, and the losses are this worker's halves."""
    torch.set_num_threads(2)
    bps.init(device="cpu")
    try:
        rank, nw = bps.rank(), bps.size()
        cfg = dict(CFG, num_layers=1, dtype=torch.float32, attn_impl="flash",
                   device="cpu")
        model = TransformerLM(**cfg,
                              generator=torch.Generator().manual_seed(3))
        ref = TransformerLM(**cfg, generator=torch.Generator().manual_seed(3))
        k = 3 if mode == "accum" else 1
        lr = 0.2
        wire = {"overlap_bf16": "bfloat16",
                "overlap_int8": "int8"}.get(mode, "float32")
        opt = torch.optim.SGD(model.parameters(), lr=lr / k)
        if mode.startswith("bucketed"):
            step = make_bucketed_overlap_step(
                _loss, opt, n_buckets=2, prefix=mode,
                multi_program=mode == "bucketed_multi")
        else:
            step = make_overlapped_train_step(
                _loss, opt, prefix=mode, backward_passes_per_step=k,
                wire_dtype=wire, wire_block=INT8_BLOCK)
        per = 2
        batches = _batches(4 * k, seed=21, rows=nw * per)
        losses = [step(model, torch.as_tensor(b[rank * per:(rank + 1) * per]
                                              )).item() for b in batches]
        # the reference: per window, each worker's summed half gradient at
        # the reference's parameters; the update applies their mean
        snapshots, errs, ref_losses = [snapshot(ref)], [], []
        for w in range(4):
            halves = []
            for r in range(nw):
                ref.zero_grad()
                for m, b in enumerate(batches[w * k:(w + 1) * k]):
                    loss = _loss(ref, torch.as_tensor(
                        b[r * per:(r + 1) * per]))
                    if r == rank:
                        g0 = {n: p.grad.clone() if p.grad is not None
                              else torch.zeros_like(p)
                              for n, p in ref.named_parameters()}
                        loss.backward()
                        ref_losses.append((w, loss.item(), {
                            n: (p.grad - g0[n]).double()
                            for n, p in ref.named_parameters()}))
                    else:
                        loss.backward()
                halves.append({n: p.grad.clone()
                               for n, p in ref.named_parameters()})
            errs.append({n: sum(wire_error(wire, h[n], INT8_BLOCK)
                                .reshape(h[n].shape) for h in halves) / nw
                         for n in halves[0]})
            with torch.no_grad():
                for n, p in ref.named_parameters():
                    p -= lr / k * sum(h[n] for h in halves) / nw
            snapshots.append(snapshot(ref))
        assert_near_reference(
            f"{mode} worker {rank}", snapshots, model.state_dict(), lr / k,
            errs, [(w, a, b, g) for a, (w, b, g) in zip(losses, ref_losses)])
        print(f"worker {rank}: {mode} OK")
        return 0
    finally:
        bps.shutdown()


if __name__ == "__main__":
    sys.exit(_worker_main(os.environ["BPS_TEST_MODE"]))


class _TwoWorkerLoopback(LoopbackClient):
    def num_workers(self):
        return 2


@pytest.mark.parametrize("credit,fits", [
    (0, True),  # the default, 4 partitions: 16.4 MB
    (4, True),  # a legacy partition count
    (4096, False),  # bytes
    (1 << 18, True)])  # exactly a step
def test_hook_pushes_need_a_step_within_the_credit(monkeypatch, credit,
                                                    fits):
    """With more than one worker, hook-driven pushes need the core's push
    budget to hold a step's 256 KiB: the core keeps a push's credit until
    its pull returns, so two workers that admit different keys first can
    each wait for the other forever (a 2-worker GPT-2-width fleet hung in
    4 of 6 runs at the default budget)."""
    monkeypatch.setenv("BYTEPS_SCHEDULING_CREDIT", str(credit))
    init_loopback(monkeypatch, _TwoWorkerLoopback())
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(64, 1024))],
                          lr=0.1)
    if fits:
        bps.DistributedOptimizer(opt)._taps.close()
    else:
        with pytest.raises(ValueError, match="BYTEPS_SCHEDULING_CREDIT"):
            bps.DistributedOptimizer(opt)


@pytest.mark.parametrize("path", ["distributed_optimizer", "overlapped"])
def test_dropped_hooks_free_the_model(monkeypatch, path):
    """The hooks a ``_TapState`` registers live on the parameters, where
    the garbage collector does not look; when they held the state, a
    dropped PS-mode DistributedOptimizer or overlapped step kept every
    parameter and gradient of its model alive for the life of the
    process (4.0 GB of the card after chip_smoke.py's phases 4-8). Once
    the optimizer or step and the model are dropped, the parameters go,
    and so do the hooks and the stager thread."""
    import gc
    import threading
    import weakref

    init_loopback(monkeypatch, LoopbackClient())
    model = torch.nn.Linear(8, 8)
    x = torch.ones(2, 8)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    if path == "distributed_optimizer":
        holder = bps.DistributedOptimizer(opt)
        model(x).sum().backward()
        holder.step()
    else:
        holder = make_overlapped_train_step(lambda m, b: m(b).sum(), opt)
        holder(model, x)
    stagers = {t for t in threading.enumerate()
               if t.name.startswith("bps_stager_")}
    weight = weakref.ref(model.weight)
    del model, opt, holder
    gc.collect()
    # the stager thread may still be returning from the window's last
    # job, whose frame holds the state until it ends
    deadline = time.monotonic() + 10
    while weight() is not None and time.monotonic() < deadline:
        time.sleep(0.01)
        gc.collect()
    assert weight() is None
    for t in stagers:
        t.join(timeout=10)
        assert not t.is_alive()
