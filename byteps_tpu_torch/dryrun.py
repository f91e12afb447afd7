"""Entry points: the flagship forward and the multi-process dry run.

Counterpart of ``__graft_entry__.py``:

- ``entry()``: the ResNet-50 bf16 forward and its example arguments;
- ``dryrun_multichip(n)``: over a world of n processes, the data-parallel
  training step of ResNet-18 (``stateful.make_stateful_train_step``: the
  gradient all-reduce, the optimizer, the BatchNorm statistics averaged)
  on a (dcn, ici) mesh, one step; ``push_pull`` of a stacked tensor; and
  each other kind of parallelism on the same processes: LlamaTiny under
  ring sequence parallelism, the MoE FFN over experts, the TP MLP and a
  GPipe schedule. Each must give finite values of the expected shape.

One process drives one device. Called inside a ``torch.distributed``
world of n processes, each process runs its part; called outside one, it
spawns n processes in a gloo world on ``localhost`` and waits for them.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import tempfile
from typing import Dict

import torch
import torch.distributed as dist

from byteps_tpu_torch.utils.ports import free_port

# seconds a spawned world may take, as the JAX dry run's subprocess
DRYRUN_TIMEOUT_S = 1800.0


def entry(device=None):
    """``(forward, (model, x))``: ResNet-50 (1000 classes, bf16) in eval
    mode and 8 images of 128 x 128 (NCHW)."""
    from byteps_tpu_torch._device import resolve_device
    from byteps_tpu_torch.models import ResNet50

    dev = resolve_device(device)
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device=dev)
    model.eval()
    x = torch.ones((8, 3, 128, 128), device=dev)

    def forward(model, x):
        with torch.no_grad():
            return model(x)

    return forward, (model, x)


def _finite(name: str, t: torch.Tensor) -> float:
    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"dry run: non-finite {name}")
    return float(t.float().abs().sum())


def _axis(name: str):
    """A 1-D mesh over the whole world: its one group."""
    from byteps_tpu_torch.parallel import Mesh
    return Mesh((dist.get_world_size(),), (name,)).group(name)


def _sequence_parallel(dev) -> float:
    """One LlamaTiny forward and backward with the sequence split over an
    ``sp`` group (ring attention: K/V blocks round the ring); the loss
    and gradients averaged over the group."""
    from byteps_tpu_torch.models import LlamaTiny, lm_loss
    from byteps_tpu_torch.parallel import tree_all_reduce
    from byteps_tpu_torch.parallel._collectives import pmean

    sp = _axis("sp")
    model = LlamaTiny(dtype=torch.float32, attn_impl="ring", sp_group=sp,
                      device=dev)
    tokens = torch.zeros((2, 8), dtype=torch.long, device=dev)
    loss = lm_loss(model(tokens), tokens)
    loss.backward()
    grads = tree_all_reduce([p.grad for p in model.parameters()],
                            ici_group=sp)
    for i, g in enumerate(grads):
        _finite(f"sp gradient {i}", g)
    return _finite("sp loss", pmean(loss.detach(), sp))


def _expert_parallel(dev) -> float:
    """A top-1 MoE FFN with one expert a process over an ``ep`` group."""
    from byteps_tpu_torch.parallel import moe_ffn

    ep = _axis("ep")
    n = dist.get_world_size()
    d, h, e, t = 16, 32, n, 8
    g = torch.Generator().manual_seed(1)
    gate_w, w1, w2 = (torch.randn(s, generator=g).mul_(0.1).to(dev)
                      for s in ((d, e), (e, d, h), (e, h, d)))
    x = torch.randn((n, t, d), generator=g).to(dev)[dist.get_rank()]
    out, aux = moe_ffn(x, gate_w, w1, w2, group=ep)
    if out.shape != x.shape:
        raise AssertionError(f"dry run: MoE output {tuple(out.shape)}")
    _finite("MoE output", out)
    return _finite("MoE aux loss", aux)


def _tensor_parallel(dev) -> float:
    """A Megatron MLP (one all-reduce per column/row pair) over ``tp``."""
    from byteps_tpu_torch.parallel import shard_columns, shard_rows, tp_mlp

    tp = _axis("tp")
    d, h = 8, 8 * dist.get_world_size()
    g = torch.Generator().manual_seed(2)
    w_in = torch.randn((d, h), generator=g).mul_(0.1).to(dev)
    w_out = torch.randn((h, d), generator=g).mul_(0.1).to(dev)
    x = torch.ones((4, d), device=dev)
    out = tp_mlp(x, shard_columns(w_in, tp), shard_rows(w_out, tp), group=tp)
    return _finite("TP output", out)


def _pipeline_parallel(dev) -> float:
    """A GPipe schedule, one stage a process, over a ``pp`` ring."""
    from byteps_tpu_torch.parallel import gpipe, stage_params

    pp = _axis("pp")
    n = dist.get_world_size()
    g = torch.Generator().manual_seed(3)
    stacked = {"w": torch.randn((n, 8, 8), generator=g).mul_(0.3).to(dev)}
    mb = torch.ones((2 * n, 3, 8), device=dev)
    out = gpipe(lambda p, a: torch.tanh(a @ p["w"]),
                stage_params(stacked, pp), mb, group=pp)
    if out.shape != mb.shape:
        raise AssertionError(f"dry run: pipeline output {tuple(out.shape)}")
    return _finite("PP output", out)


def _dryrun_impl(device=None) -> Dict[str, float]:
    """This process's part of the dry run in the current world."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import ResNet18
    from byteps_tpu_torch.parallel import MeshSpec, build_mesh
    from byteps_tpu_torch.stateful import make_stateful_train_step

    n = dist.get_world_size()
    # two levels whenever they divide: dcn the cross-host leg, ici the
    # intra-host collectives
    dcn = 2 if n % 2 == 0 and n > 1 else 1
    mesh = build_mesh(MeshSpec(dcn=dcn, ici=n // dcn))
    bps.init(device=device, mesh=mesh)
    try:
        dev = bps.device()
        model = ResNet18(num_classes=10, dtype=torch.float32, device=dev)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        step = make_stateful_train_step(model, opt)
        x = torch.ones((1, 3, 32, 32), device=dev)
        y = torch.zeros((1,), dtype=torch.long, device=dev)
        out = {"resnet18_loss": _finite("ResNet-18 loss", step((x, y)))}

        stacked = torch.ones((n, 7), device=dev)
        pulled = bps.push_pull(stacked[dist.get_rank()], average=False)
        if not torch.equal(pulled, torch.full_like(pulled, float(n))):
            raise AssertionError(f"dry run: push_pull gave {pulled}")
        out["push_pull"] = _finite("push_pull", pulled)
        out["sp_loss"] = _sequence_parallel(dev)
        out["moe_aux"] = _expert_parallel(dev)
        out["tp_out"] = _tensor_parallel(dev)
        out["pp_out"] = _pipeline_parallel(dev)
    finally:
        bps.shutdown()
    return out


def _spawned(rank: int, n: int, port: int, device, out_dir: str) -> None:
    torch.set_num_threads(1)
    os.environ.setdefault("BYTEPS_PS_MODE", "collective")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=300))
    try:
        res = _dryrun_impl(device)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def dryrun_multichip(n_devices: int, device=None) -> Dict[str, float]:
    """Run the dry run over ``n_devices`` processes and return this
    process's readings (rank 0's when it spawns the world). In a world of
    that size each process runs its part; with no world, n processes are
    spawned in a gloo world, each computing on ``device`` (the current
    CUDA device unless given; ``"cpu"`` for the CPU)."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a world of "
                             f"{dist.get_world_size()}")
        return _dryrun_impl(device)
    import time

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        ctx = mp.spawn(_spawned, args=(n_devices, free_port(), device, tmp),
                       nprocs=n_devices, join=False)
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        try:
            # join returns False each time one process ends before the rest
            while not ctx.join(timeout=max(0.0,
                                           deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"dryrun_multichip({n_devices}) "
                                       f"still running after "
                                       f"{DRYRUN_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        runs = []
        for r in range(n_devices):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                runs.append(json.load(f))
    if not all(math.isfinite(v) for run in runs for v in run.values()):
        raise AssertionError(f"dry run: non-finite readings {runs}")
    return runs[0]
