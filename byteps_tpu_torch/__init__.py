"""byteps_tpu_torch: the PyTorch/CUDA port of byteps_tpu.

Counterpart of ``byteps_tpu/jax/__init__.py``: ``init``, ``shutdown``,
``rank``/``size``/``local_rank``/``local_size``, ``push_pull`` (with
``push_pull_async``/``poll``/``synchronize``), ``declare_tensor``,
``broadcast_parameters``, ``broadcast_optimizer_state`` and
``DistributedOptimizer``; and the in-place API of the reference's torch
plugin: ``push_pull_inplace_``, ``push_pull_async_inplace_`` and
``declare``.

One process drives one GPU. The local process group (``torch.distributed``,
NCCL on the card, gloo on the CPU) plays the part of the JAX mesh's ``ici``
axis; in PS mode the cross-host level goes through the C++ KV client to the
CPU parameter servers (``byteps_tpu_torch.ps``). Tensors are per-process
values (the Horovod contract), not stacked replicas. Entry points run on
the card unless the caller passes ``device="cpu"``.

The package imports torch and numpy, and nothing of JAX or of byteps_tpu:
the host runtime it needs (config, partition, the C++ core, server,
monitor) is its own copy.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

import torch
import torch.distributed as dist

from byteps_tpu_torch._device import resolve_device
from byteps_tpu_torch.compression import Compression, Compressor
from byteps_tpu_torch.config import Config, get_config
from byteps_tpu_torch.parallel import hierarchical as _h
from byteps_tpu_torch.partition import TensorRegistry

__all__ = [
    "init", "shutdown", "initialized", "rank", "size", "local_rank",
    "local_size", "device", "push_pull", "push_pull_async", "poll",
    "synchronize", "push_pull_inplace_", "push_pull_async_inplace_",
    "declare", "declare_tensor", "broadcast_parameters",
    "broadcast_optimizer_state", "DistributedOptimizer", "Compression",
]


@dataclasses.dataclass
class _State:
    config: Config
    registry: TensorRegistry
    device: torch.device
    group: Optional[dist.ProcessGroup]  # the local level; None = 1 process
    ps_client: Any = None  # C++ KV client (PS mode)


_state: Optional[_State] = None
_lock = threading.Lock()


def init(config: Optional[Config] = None, *, device=None,
         group: Optional[dist.ProcessGroup] = None) -> None:
    """Initialise byteps_tpu_torch: the tensor registry, the local process
    group (``group``, else the default group when ``torch.distributed`` is
    initialised, else this process alone), and in PS mode the C++ KV
    client's connection to the scheduler. ``device`` is where this
    process computes: the current CUDA device unless given."""
    global _state
    from byteps_tpu_torch import ps as _ps
    # Settle a stale async op against the OLD client before re-init.
    _ps.drain_bridge()
    with _lock:
        cfg = config or get_config(reload=True)
        dev = resolve_device(device)
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        registry = TensorRegistry(cfg.partition_bytes,
                                  max(1, cfg.num_server))
        ps_client = None
        if cfg.use_ps:
            if group is not None and dist.get_world_size(group) > 1:
                raise NotImplementedError(
                    f"PS mode with {dist.get_world_size(group)} processes "
                    "in the local group is not ported yet (ROADMAP: "
                    "multi-GPU-per-host PS, a local group larger than 1 "
                    "feeding the PS leg); run one worker per GPU with no "
                    "local group")
            from byteps_tpu_torch.core import ffi as _ffi
            ps_client = _ffi.Worker.start(cfg)
        _ps.reset_declare_cache()
        _state = _State(cfg, registry, dev, group, ps_client)


def shutdown() -> None:
    """Tear down (reference: byteps_shutdown)."""
    global _state
    from byteps_tpu_torch import ps as _ps
    # In-flight async bridge ops still hold staged host buffers the core
    # pulls into: settle them against a live fleet first.
    _ps.drain_bridge()
    with _lock:
        if _state is not None and _state.ps_client is not None:
            _state.ps_client.shutdown()
        _ps.reset_declare_cache()
        _state = None


def initialized() -> bool:
    return _state is not None


def _st() -> _State:
    if _state is None:
        raise RuntimeError("byteps_tpu_torch.init() has not been called")
    return _state


def device() -> torch.device:
    """The device this process computes on."""
    return _st().device


def rank() -> int:
    """This worker's index in [0, size()). PS mode: the fleet-wide worker
    rank (DMLC_WORKER_ID order); otherwise the ``torch.distributed`` rank
    (0 without a process group)."""
    st = _st()
    if st.ps_client is not None:
        return st.ps_client.worker_rank()
    return dist.get_rank() if dist.is_initialized() else 0


def size() -> int:
    """Number of workers: the PS fleet's in PS mode, else the
    ``torch.distributed`` world size (1 without a process group)."""
    st = _st()
    if st.ps_client is not None:
        return st.ps_client.num_workers()
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index among processes on the same host."""
    return _st().config.local_rank


def local_size() -> int:
    """Number of processes in the local group."""
    return _h.group_size(_st().group)


# --- push_pull -------------------------------------------------------------

def push_pull(tensors, average: bool = True, name: Optional[str] = None,
              compression: Compressor = Compression.none):
    """Sum (or average) a tensor, list or dict of tensors across all
    workers; returns the same structure.

    The local group reduces first (the hierarchical all-reduce), with the
    ``compression`` cast applied before and undone after. In PS mode the
    result then crosses the host boundary through the C++ KV client, so
    the reduction is global across worker processes. ``name`` keys the PS
    registry; unnamed calls share a shape-keyed name and must be issued in
    the same order on every worker.
    """
    st = _st()
    leaves, unflatten = _h.tree_flatten(tensors)
    if not leaves:
        return tensors
    dtypes = [t.dtype for t in leaves]
    wire = _h.tree_all_reduce([compression.compress(t) for t in leaves],
                              ici_group=st.group, average=average)
    if st.ps_client is not None:
        from byteps_tpu_torch import ps as _ps
        wire = _ps.ps_push_pull(wire, average=average,
                                prefix=name or "push_pull")
    return unflatten([compression.decompress(t, d)
                      for t, d in zip(wire, dtypes)])


@dataclasses.dataclass
class Handle:
    """An in-flight push_pull: in PS mode ``value`` is the Future of the
    bridge thread's round trip, otherwise the finished result."""

    value: Any


def push_pull_async(tensors, average: bool = True,
                    name: Optional[str] = None,
                    compression: Compressor = Compression.none) -> Handle:
    """Non-blocking push_pull. PS mode: the round trip runs on the
    ordered bridge thread, so this returns at once and declares keep a
    fleet-consistent order against synchronous calls; ``synchronize``
    joins it. Collective mode: the collectives run before this returns."""
    st = _st()
    if st.ps_client is not None:
        from byteps_tpu_torch import ps as _ps
        return Handle(_ps.submit_ordered(push_pull, tensors, average, name,
                                         compression))
    return Handle(push_pull(tensors, average=average, name=name,
                            compression=compression))


def _is_future(v) -> bool:
    return hasattr(v, "done") and hasattr(v, "result")


def poll(handle: Handle) -> bool:
    """True iff the result is ready (reference: byteps_torch_poll)."""
    return handle.value.done() if _is_future(handle.value) else True


def synchronize(handle: Handle):
    """Block until the result is ready and return it."""
    if _is_future(handle.value):
        return handle.value.result()
    return handle.value


def _write_back(tensor: torch.Tensor, average: bool, name: Optional[str]):
    out = push_pull(tensor, average=average, name=name)
    with torch.no_grad():
        tensor.copy_(out)
    return tensor


def push_pull_async_inplace_(tensor: torch.Tensor, average: bool = True,
                             name: Optional[str] = None) -> Handle:
    """Non-blocking push_pull of one tensor whose result is written into
    ``tensor``; ``synchronize`` of the handle waits for that and returns
    ``tensor`` (reference: byteps.torch push_pull_async_inplace_)."""
    st = _st()
    if st.ps_client is not None:
        from byteps_tpu_torch import ps as _ps
        return Handle(_ps.submit_ordered(_write_back, tensor, average, name))
    return Handle(_write_back(tensor, average, name))


def push_pull_inplace_(tensor: torch.Tensor, average: bool = True,
                       name: Optional[str] = None) -> torch.Tensor:
    """Blocking push_pull of one tensor, written into ``tensor``, which is
    returned (reference: byteps.torch push_pull_inplace_)."""
    return synchronize(push_pull_async_inplace_(tensor, average, name))


# --- declare / broadcast ----------------------------------------------------

def declare(name: str, tensor: torch.Tensor) -> None:
    """Pre-register ``tensor`` under ``name`` (reference: byteps.torch
    declare): ``declare_tensor`` with its shape and dtype."""
    declare_tensor(name, tensor.shape, tensor.dtype)


def declare_tensor(name: str, shape, dtype) -> None:
    """Pre-register a tensor (reference: byteps_declare_tensor): fixes its
    declaration-order priority and partition/key table."""
    dtype_name = (str(dtype).replace("torch.", "")
                  if isinstance(dtype, torch.dtype) else str(dtype))
    _st().registry.declare(name, tuple(shape), dtype_name)


def broadcast_parameters(params, root_rank: int = 0,
                         name: Optional[str] = None):
    """Overwrite ``params`` (a tensor, list or dict of tensors, such as
    ``model.state_dict()``) in place with ``root_rank``'s values and return
    it (reference: broadcast_parameters). Over the local group this is a
    ``torch.distributed`` broadcast; in PS mode the tensors then round-trip through
    the servers so every worker holds the root's values. ``name`` keys
    the PS registry for that leg."""
    st = _st()
    leaves, _ = _h.tree_flatten(params)
    if not leaves:
        return params
    synced = _h.tree_broadcast(list(leaves), root=root_rank,
                               ici_group=st.group)
    if st.ps_client is not None:
        from byteps_tpu_torch import ps as _ps
        synced = _ps.ps_broadcast(synced, root_rank=root_rank,
                                  prefix=name or "param")
    with torch.no_grad():
        for dst, src in zip(leaves, synced):
            if dst is not src:
                dst.copy_(src)
    return params


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0, name: str = "opt_state"):
    """Overwrite the tensors of ``optimizer``'s state in place with
    ``root_rank``'s, in one broadcast_parameters call (one batched host
    round trip in PS mode). Non-tensor entries are left as they are; pass
    a distinct ``name`` when broadcasting several optimizer states."""
    tensors = [v for _, st in sorted(optimizer.state_dict()["state"].items())
               for _, v in sorted(st.items()) if torch.is_tensor(v)]
    if tensors:
        broadcast_parameters(tensors, root_rank=root_rank, name=name)
    return optimizer


# --- DistributedOptimizer ---------------------------------------------------

class DistributedOptimizer:
    """Wrap a ``torch.optim.Optimizer`` so that the gradients are summed
    (mean with ``average``) across workers before its ``step()``
    (reference: byteps.torch DistributedOptimizer). Other attributes pass
    through to the wrapped optimizer.

    PS mode: a ``register_post_accumulate_grad_hook`` on each parameter
    starts its gradient's D2H copy and push the moment backward has
    accumulated it, as in ``overlap.py`` (the same ``_TapState``, prefix
    ``"grad"``), so communication overlaps the rest of backward;
    ``step()`` waits for the pulls, writes the sums into ``.grad`` and
    steps. ``compression`` (``bf16``/``fp16``) casts each gradient on the
    card, and the servers sum that dtype, as ``push_pull`` has them do
    (f32 when a codec is configured, as ``ps._wire_plan`` declares). Every
    parameter must get a gradient in each backward pass. ``timings`` holds
    the last step's pushes and the time the last pull was waited (host
    clock).

    Collective mode: ``step()`` push_pulls every ``.grad`` first (the JAX
    DistributedOptimizer leaves overlap there to the compiler).

    ``backward_passes_per_step`` > 1 is the reference's accumulation
    contract: gradients accumulate in ``.grad`` over that many backward
    passes and are communicated once (PS mode: from the hook of the last
    pass); dividing by the count is the caller's, as in the reference.
    """

    _WIRES = {"none": "float32", "bf16": "bfloat16", "fp16": "float16"}

    def __init__(self, optimizer: torch.optim.Optimizer, *,
                 average: bool = True,
                 compression: Compressor = Compression.none,
                 backward_passes_per_step: int = 1):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self.average = average
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._taps = None
        self.timings: dict = {}
        client = _st().ps_client
        if client is not None:
            if compression.name not in self._WIRES:
                raise ValueError(
                    f"Compression {compression.name!r} has no PS-mode "
                    f"wire; use one of {sorted(self._WIRES)}")
            from byteps_tpu_torch.overlap import _TapState
            self._taps = _TapState(
                client, [p for g in optimizer.param_groups
                         for p in g["params"]], "grad", average, None,
                wire_dtype=self._WIRES[compression.name],
                backward_passes_per_step=backward_passes_per_step,
                sum_wire=True)

    def __getattr__(self, attr):
        return getattr(self.__dict__["optimizer"], attr)

    def synchronize(self) -> None:
        """Replace every ``.grad`` with its sum across workers (PS mode:
        wait for the pushes the hooks started)."""
        if self._taps is not None:
            try:
                self._taps.collect()
                self.timings = dict(self._taps.timeline)
            finally:
                self._taps.reset_window()
            return
        params = [p for g in self.optimizer.param_groups
                  for p in g["params"] if p.grad is not None]
        if not params:
            return
        grads = push_pull([p.grad for p in params], average=self.average,
                          name="grad", compression=self.compression)
        for p, g in zip(params, grads):
            p.grad = g

    def step(self, closure=None):
        self.synchronize()
        return self.optimizer.step(closure)

    def zero_grad(self, set_to_none: bool = True) -> None:
        if self._taps is not None:
            # a failed step may have left pushes in flight: settle them
            # and start the next window clean
            self._taps.settle()
            self._taps.reset_window()
        self.optimizer.zero_grad(set_to_none=set_to_none)
