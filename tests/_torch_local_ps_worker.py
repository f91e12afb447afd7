"""Gloo worlds of two processes that form one host in PS mode, for
``tests/test_torch_local_ps.py``.

Each world runs ``local_ps_worker`` on the inputs the test process saved
(``_torch_sp_worker.run_once``) and saves what each rank saw. Rank 0 is
the local root: ``ffi.Worker.start`` gives it a ``MirrorServer``, the
other rank must never call it. The ranks train the narrow
``TransformerLM`` on their halves of each batch through every PS path,
and try ``push_pull``, ``broadcast_parameters``, checkpoint restore,
``push_pull_async`` beside a hooked step and the BatchNorm step
(``stateful.py``) across the group. It imports no JAX.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ps_loopback import LoopbackClient

CFG = dict(vocab_size=64, num_layers=2, d_model=64, num_heads=4,
           mlp_dim=128, max_len=16)
LR = 0.1
INT8_BLOCK = 48  # a leaf's shard block: min(48, ceil(n / 2))
# path -> (builder, step builder keyword arguments, average)
PATHS = {
    "plain": ("train_step", {}, True),
    "plain_sum": ("train_step", {}, False),
    "overlap_f32": ("overlap", {}, True),
    "overlap_f32_sum": ("overlap", {}, False),
    "overlap_bf16": ("overlap", {"wire_dtype": "bfloat16"}, True),
    "overlap_int8": ("overlap", {"wire_dtype": "int8",
                                 "wire_block": INT8_BLOCK}, True),
    "bucketed_multi": ("bucketed", {"multi_program": True}, True),
    "bucketed_single": ("bucketed", {"multi_program": False}, True),
    "bucketed_multi_bf16": ("bucketed", {"multi_program": True,
                                         "wire_dtype": "bfloat16"}, True),
    "distributed_optimizer": ("optimizer", {}, True),
    "distributed_optimizer_bf16": ("optimizer", {"compression": "bf16"},
                                   True),
}


class MirrorServer(LoopbackClient):
    """The core's client of one host in a fleet of two whose other host
    pushes what this one pushes. A push keeps a copy of the array as it
    is when pushed, and its wait writes the servers' result into the
    array: the copy for a mean, twice the copy for a sum (f32 only). So a
    value pushed before it was staged, or read back before its pull,
    shows, and a sum shows the second host."""

    def __init__(self):
        super().__init__()
        self.pending = {}

    def num_workers(self):
        return 2

    def barrier(self):
        with self.lock:
            self.barriers = getattr(self, "barriers", 0) + 1

    def push_pull(self, tensor_id, arr, average=True, async_mode=False,
                  dtype=None):
        h = super().push_pull(tensor_id, arr, average, async_mode, dtype)
        with self.lock:
            self.pending[h] = (arr, arr.copy(), average)
        return h

    def wait(self, handle):
        super().wait(handle)
        with self.lock:
            pending = self.pending.pop(handle, None)
        if pending is None:  # a broadcast: the array is the root's
            return
        arr, pushed, average = pending
        if average:
            arr[...] = pushed
        else:
            assert arr.dtype == np.float32, arr.dtype
            arr[...] = 2 * pushed


def _loss(model, tokens):
    from byteps_tpu_torch.models import lm_loss
    return lm_loss(model(tokens), tokens)


def _model(params):
    from byteps_tpu_torch.models import TransformerLM, from_flax
    model = TransformerLM(**CFG, dtype=torch.float32, attn_impl="flash",
                          device="cpu")
    model.load_state_dict(from_flax(params))
    return model


def _state_of(step):
    """The ``_TapState`` behind a step or optimizer built below."""
    return step.close.__self__


def _build(path, model, lr, average):
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.bucketed import make_bucketed_overlap_step
    from byteps_tpu_torch.overlap import make_overlapped_train_step
    from byteps_tpu_torch.training import make_train_step
    kind, kw, _ = PATHS[path]
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    if kind == "train_step":
        return make_train_step(_loss, opt, average=average, ps_prefix=path)
    if kind == "overlap":
        return make_overlapped_train_step(_loss, opt, average=average,
                                          prefix=path, **kw)
    if kind == "bucketed":
        return make_bucketed_overlap_step(_loss, opt, n_buckets=3,
                                          average=average, prefix=path, **kw)
    dopt = bps.DistributedOptimizer(
        opt, average=average,
        compression=getattr(bps.Compression, kw.get("compression", "none")))

    def step(model, tokens):
        dopt.zero_grad()
        loss = _loss(model, tokens)
        loss.backward()
        dopt.step()
        step.timings = dopt.timings
        return loss.detach()
    step.close = dopt._taps.close
    return step


def _plant(fault, step, rank):
    """Plant ``fault`` in this rank's path ``step`` (see the test)."""
    from byteps_tpu_torch import local_stage, ps
    copy = ps.copy_to_host
    if fault == "slices_swapped":
        state = _state_of(step)
        other = {id(state.wire_bufs[(i, rank)][0]):
                 state.wire_bufs[(i, 1 - rank)][0]
                 for i in range(len(state.params))}

        def swapped(pairs, ready, stream):
            return copy([(src, other.get(id(dst), dst))
                         for src, dst in pairs], ready, stream)
        ps.copy_to_host = swapped
    elif fault == "pushed_before_signal":
        if rank == 0:
            local_stage.Segment.wait_landed = lambda *a, **k: None
        else:
            def late(pairs, ready, stream):
                time.sleep(0.05)
                return copy(pairs, ready, stream)
            ps.copy_to_host = late


def _run_path(path, inputs, rank, client, fault=None):
    """STEPS steps of ``path`` on this rank's half of each batch."""
    from byteps_tpu_torch.utils import timeline
    _, _, average = PATHS[path]
    model = _model(inputs["params"])
    first = len(client.declares) if client else 0
    lr = LR if average else LR / 4
    step = _build(path, model, lr, average)
    if fault:
        _plant(fault, step, rank)
    half = inputs["batches"][0].shape[0] // 2
    out = {"losses": [], "d2h_bytes": [], "pushed_bytes": [], "split_s": []}
    plain = PATHS[path][0] == "train_step"
    for b in inputs["batches"]:
        if plain:  # its legs are spans of the step trace's record
            timeline.start_steps()
        loss = step(model, torch.as_tensor(b[rank * half:(rank + 1) * half]))
        out["losses"].append(loss.item())
        if plain:
            legs = timeline.leg_seconds(timeline.stop_steps())
            out["d2h_bytes"].append(legs.pop("d2h_bytes"))
            out["pushed_bytes"].append(legs.pop("pushed_bytes"))
            out["split_s"].append(legs)
        else:
            t = step.timings
            out["d2h_bytes"].append(sum(n for _, n in t["staged"]))
            out["pushed_bytes"].append(sum(n for _, n in t["pushes"]))
            out["split_s"].append(dict(t["split_s"]))
    if hasattr(step, "close"):
        step.close()
    out["state"] = {k: v.detach().numpy().copy()
                    for k, v in model.state_dict().items()}
    out["declares"] = client.declares[first:] if client else []
    return out


def _collective_checks(rank, client):
    """push_pull (sync, async, in place, a bf16 wire), the async step's
    refusal, broadcast_parameters from a local rank other than 0,
    broadcast_optimizer_state to a fresh rank and a checkpoint restored
    across the group."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch import ps
    from byteps_tpu_torch.training import make_async_train_step
    from byteps_tpu_torch.utils import restore_checkpoint, save_checkpoint
    out = {}
    x = torch.full((5,), float(rank + 1))
    tree = {"a": torch.arange(12.0).view(3, 4) * (rank + 1),
            "b": torch.full((7,), 10.0 * (rank + 1))}
    out["mean"] = bps.push_pull(x, average=True, name="pp").tolist()
    out["sum"] = bps.push_pull(x, average=False, name="pp_sum").tolist()
    out["tree"] = {k: v.tolist() for k, v in bps.push_pull(
        tree, name="tree").items()}
    out["async"] = bps.synchronize(bps.push_pull_async(
        x * 4, name="pp_async")).tolist()
    y = x.clone()
    out["inplace_same"] = bps.push_pull_inplace_(y, name="inplace") is y
    out["inplace"] = y.tolist()
    out["bf16"] = bps.push_pull(x / 3, name="pp_bf16",
                                compression=bps.Compression.bf16).tolist()
    try:
        bps.push_pull(x, name="pp_int8", compression=bps.Compression.int8)
        out["int8_refused"] = None
    except ValueError as e:
        out["int8_refused"] = str(e)
    try:
        make_async_train_step(_loss, torch.optim.SGD(
            [torch.nn.Parameter(torch.zeros(2))], lr=0.1), None)
        out["async_refused"] = None
    except ValueError as e:
        out["async_refused"] = str(e)
    params = {"w": torch.full((3, 5), float(rank)),
              "b": torch.arange(4.0) + 100 * rank}
    bps.broadcast_parameters(params, root_rank=1, name="bcast")
    out["broadcast"] = {k: v.tolist() for k, v in params.items()}
    # a stepped root and a fresh local rank 1: the state, its step count
    # and the lr come from the root, the parameters stay as they were
    torch.manual_seed(rank)
    lin = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(lin.parameters(), lr=1e-3 * (rank + 1),
                            weight_decay=0.1)
    if rank == 0:
        lin(torch.ones(2, 3)).sum().backward()
        opt.step()
    kept = [p.detach().clone() for p in lin.parameters()]
    bps.broadcast_optimizer_state(opt, root_rank=0)
    out["opt_state"] = {
        "lr": opt.param_groups[0]["lr"],
        "state": [(pid, k, v.tolist()) for pid, s in sorted(
            opt.state_dict()["state"].items()) for k, v in sorted(s.items())],
        "moved": [not torch.equal(p.detach(), k)
                  for p, k in zip(lin.parameters(), kept)]}
    ckpt = os.path.join(os.environ["BYTEPS_LOCAL_STAGE_DIR"], "..", "ckpt")
    save_checkpoint(ckpt, {"w": torch.arange(6.0) + 7}, 1)
    ps.ps_barrier()  # the group, the root through the scheduler, the group
    out["fleet_barriers"] = getattr(client, "barriers", 0) if client else 0
    state, step = restore_checkpoint(ckpt, {"w": torch.zeros(6)})
    out["restored"] = (state["w"].tolist(), step)
    return out


def _concurrent(inputs, rank):
    """``overlap_f32`` and ``distributed_optimizer`` again, each step with
    a ``push_pull_async`` of a metric in flight while the step's round
    issues the group's reduce-scatters: started before the step (after
    backward for the optimizer) behind a bridge job that holds rank 1's
    bridge 0.3 s and rank 0's not at all, and waited after the step.
    Returns each path's metric results and parameters."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch import ps
    from byteps_tpu_torch.overlap import make_overlapped_train_step
    half = inputs["batches"][0].shape[0] // 2
    out = {}
    for path in ("overlap_f32", "distributed_optimizer"):
        model = _model(inputs["params"])
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        if path == "overlap_f32":
            step = make_overlapped_train_step(_loss, opt, prefix="concurrent")
            close = step.close
        else:
            dopt = bps.DistributedOptimizer(opt)
            close = dopt._taps.close
        metrics = []
        for t, b in enumerate(inputs["batches"]):
            tokens = torch.as_tensor(b[rank * half:(rank + 1) * half])
            metric = torch.full((5,), float(rank + t))
            ps.submit_ordered(time.sleep, 0.3 * rank)
            if path == "overlap_f32":
                h = bps.push_pull_async(metric, name="metric")
                step(model, tokens)
            else:
                dopt.zero_grad()
                _loss(model, tokens).backward()
                h = bps.push_pull_async(metric, name="metric")
                dopt.step()
            metrics.append(bps.synchronize(h).tolist())
        close()
        out[path] = {"metrics": metrics,
                     "state": {k: v.detach().numpy().copy()
                               for k, v in model.state_dict().items()}}
    return out


def _stateful():
    """Two steps of make_stateful_train_step on ResNet-18 at 4 filters,
    this rank's two 32 x 32 images a step; (losses, state)."""
    from byteps_tpu_torch.models import resnet
    from byteps_tpu_torch.stateful import make_stateful_train_step
    rank = dist.get_rank()
    model = resnet.ResNet18(num_classes=10, num_filters=4,
                            dtype=torch.float32,
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    step = make_stateful_train_step(
        model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        ps_prefix="stateful")
    rng = np.random.default_rng(5)
    losses = []
    for _ in range(2):
        x = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
        y = rng.integers(0, 10, size=4)
        mine = slice(2 * rank, 2 * rank + 2)
        losses.append(step((torch.from_numpy(x[mine]),
                            torch.from_numpy(y[mine]))).item())
    return losses, {k: v.detach().numpy().copy()
                    for k, v in model.state_dict().items()}


def local_ps_worker(rank, world, port, out_dir):
    """One rank of a host of ``world`` gloo processes (see the module
    docstring); ``inputs["mode"]``: ``parity`` runs every path and check,
    a planted fault's name runs ``overlap_f32_sum`` with that fault."""
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"),
                        weights_only=False)
    stage = os.path.join(out_dir, "stage")
    os.makedirs(stage, exist_ok=True)
    torch.set_num_threads(1)
    os.environ.update({
        "BYTEPS_PS_MODE": "ps", "BYTEPS_LOCAL_RANK": str(rank),
        "BYTEPS_LOCAL_SIZE": str(world), "BYTEPS_LOCAL_STAGE_DIR": stage,
        "BYTEPS_SCHEDULING_CREDIT": str(1 << 30),
        "BYTEPS_TAP_TIMEOUT_S": str(inputs.get("timeout_s", 60))})
    import datetime
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core import ffi
    started = []
    client = MirrorServer()

    def start(cls, cfg):
        started.append(rank)
        return client
    ffi.Worker.start = classmethod(start)
    out = {}
    try:
        bps.init(device="cpu")
        root = client if rank == 0 else None
        out["roles"] = {"started": started, "rank": bps.rank(),
                        "size": bps.size(), "local_rank": bps.local_rank(),
                        "local_size": bps.local_size()}
        if inputs["mode"] == "parity":
            out["paths"] = {p: _run_path(p, inputs, rank, root)
                            for p in PATHS}
            out["checks"] = _collective_checks(rank, root)
            out["concurrent"] = _concurrent(inputs, rank)
            out["stateful_ps"] = _stateful()
            bps.shutdown()
            os.environ["BYTEPS_PS_MODE"] = "collective"
            bps.init(device="cpu")
            out["stateful_collective"] = _stateful()
        else:
            out["paths"] = {"overlap_f32_sum": _run_path(
                "overlap_f32_sum", inputs, rank, root, inputs["mode"])}
        out["client_calls"] = (len(client.declares), len(client.pushes))
    finally:
        if bps.initialized():
            bps.shutdown()
        out["stage_left"] = sorted(os.listdir(stage))
        torch.save(out, os.path.join(out_dir, f"r{rank}.pt"))
        dist.destroy_process_group()


def dying_worker(rank, world, port, out_dir):
    """A host of two whose rank 1 dies in its first overlapped step, right
    after copying its first shard into the shared staging and before
    signalling it. Rank 0 saves the error its step raised and what is
    left in the staging directory."""
    from byteps_tpu_torch import local_stage
    if rank == 1:
        local_stage.Segment.land = lambda *a, **k: os._exit(3)
    try:
        local_ps_worker(rank, world, port, out_dir)
    except RuntimeError as e:
        stage = os.path.join(out_dir, "stage")
        torch.save({"error": str(e), "stage_left": sorted(os.listdir(stage))},
                   os.path.join(out_dir, f"r{rank}.pt"))


def fleet_worker() -> int:
    """One process of a host of a real fleet (the ``-m ps`` test): the
    launcher's ``--workers-per-host`` sets BYTEPS_LOCAL_RANK and
    BYTEPS_LOCAL_SIZE, BPS_TEST_LOCAL_PORT names the host's gloo
    rendezvous. Trains a one-layer TransformerLM 3 steps through the plain
    step and through the overlapped f32 step, on rows [2 r, 2 r + 2) of
    each batch for global rank r, and holds each to one process on the
    whole batches."""
    import datetime

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import TransformerLM
    torch.set_num_threads(1)
    k = int(os.environ["BYTEPS_LOCAL_SIZE"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:"
        f"{os.environ['BPS_TEST_LOCAL_PORT']}",
        rank=int(os.environ["BYTEPS_LOCAL_RANK"]), world_size=k,
        timeout=datetime.timedelta(seconds=120))
    bps.init(device="cpu")
    try:
        rank, size = bps.rank(), bps.size()
        host = int(os.environ["DMLC_WORKER_ID"])
        assert (rank, size) == (host * k + dist.get_rank(), 2 * k), (
            rank, size)
        cfg = dict(CFG, num_layers=1, dtype=torch.float32,
                   attn_impl="flash", device="cpu")
        rng = np.random.default_rng(21)
        batches = [torch.as_tensor(rng.integers(
            0, CFG["vocab_size"], size=(2 * size, CFG["max_len"])))
            for _ in range(3)]
        for path in ("plain", "overlap_f32"):
            model = TransformerLM(**cfg,
                                  generator=torch.Generator().manual_seed(3))
            ref = TransformerLM(**cfg,
                                generator=torch.Generator().manual_seed(3))
            step = _build(path, model, LR, True)
            ref_opt = torch.optim.SGD(ref.parameters(), lr=LR)
            for b in batches:
                step(model, b[2 * rank:2 * rank + 2])
                ref_opt.zero_grad()
                _loss(ref, b).backward()
                ref_opt.step()
            if hasattr(step, "close"):
                step.close()
            for (name, got), want in zip(model.state_dict().items(),
                                         ref.state_dict().values()):
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{path} {name}")
        print(f"rank {rank}: local PS fleet OK", flush=True)
        return 0
    finally:
        bps.shutdown()
        dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(fleet_worker())
