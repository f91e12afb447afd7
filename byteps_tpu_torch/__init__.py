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
axis; in collective mode a mesh's ``dcn`` group may play its ``dcn`` axis,
and in PS mode the cross-host level goes through the C++ KV client to the
CPU parameter servers (``byteps_tpu_torch.ps``). In PS mode one client
serves a host: local rank 0 holds it, and a local group of k > 1 feeds it
through host staging the k processes share (``local_stage``), as the
reference's root process does. Tensors are per-process values (the
Horovod contract), not stacked replicas. Entry points run on the card
unless the caller passes ``device="cpu"``.

The package imports torch and numpy, and nothing of JAX or of byteps_tpu:
the host runtime it needs (config, partition, the C++ core, server,
monitor) is its own copy.
"""

from __future__ import annotations

import collections
import dataclasses
import io
import threading
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

from byteps_tpu_torch._device import resolve_device
from byteps_tpu_torch.compression import QUANTIZED, Compression, Compressor
from byteps_tpu_torch.config import Config, get_config
from byteps_tpu_torch.parallel import hierarchical as _h
from byteps_tpu_torch.parallel.mesh import Mesh, set_global_mesh
from byteps_tpu_torch.partition import TensorRegistry
from byteps_tpu_torch.utils import timeline as _tl

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
    ps: bool = False  # PS mode: the servers are the cross-host level
    ps_client: Any = None  # C++ KV client: PS mode, local rank 0 only
    dcn_group: Optional[dist.ProcessGroup] = None  # collective mode's dcn
    # PS mode: this host's index among the fleet's hosts and their number
    # (the root client's worker_rank() and num_workers() at init)
    host_rank: int = 0
    num_hosts: int = 1
    # name -> C-core codec string that ``declare`` set for it ("" off)
    codecs: dict = dataclasses.field(default_factory=dict)


_state: Optional[_State] = None
_lock = threading.Lock()


def init(config: Optional[Config] = None, *, device=None,
         group: Optional[dist.ProcessGroup] = None,
         mesh: Optional[Mesh] = None) -> None:
    """Initialise byteps_tpu_torch: the tensor registry, the process
    groups, and in PS mode the C++ KV client's connection to the
    scheduler. ``device`` is where this process computes: the current
    CUDA device unless given.

    The local level is ``group``, else the default group when
    ``torch.distributed`` is initialised, else this process alone. A
    ``mesh`` (``parallel.mesh.build_mesh``) replaces ``group``: its
    ``ici`` axis is the local level and, in collective mode, its ``dcn``
    axis the cross-host level, as the JAX mesh's axes are; it becomes the
    global mesh. In PS mode the servers are the cross-host level, so a
    mesh whose ``dcn`` axis has more than one process is refused there.

    PS mode with a local group of k processes (one a GPU; the launcher's
    ``--workers-per-host k`` sets ``BYTEPS_LOCAL_RANK`` and
    ``BYTEPS_LOCAL_SIZE``): only local rank 0 starts the core's client,
    one a host, and ``DMLC_NUM_WORKER`` counts hosts, as in the JAX
    package and the reference. The group's ranks must each be their
    ``BYTEPS_LOCAL_RANK`` and agree on ``BYTEPS_LOCAL_SIZE`` = k. The
    PS-mode steps, ``push_pull`` and ``broadcast_parameters`` then
    reduce over the group and send one gradient a host through the root
    (``ps.local_push_pull``, ``overlap._TapState``)."""
    global _state
    from byteps_tpu_torch import ps as _ps
    # Settle a stale async op against the OLD client before re-init.
    _ps.drain_bridge()
    with _lock:
        cfg = config or get_config(reload=True)
        dev = resolve_device(device)
        dcn_group = None
        if mesh is not None:
            group, dcn_group = (
                mesh.group(a) if a in mesh.axis_names else None
                for a in (cfg.ici_axis, cfg.dcn_axis))
        elif group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        registry = TensorRegistry(cfg.partition_bytes,
                                  max(1, cfg.num_server))
        ps_client, hosts = None, (0, 1)
        if cfg.use_ps:
            if _h.group_size(dcn_group) > 1:
                raise ValueError(
                    "PS mode: the servers are the cross-host level; a "
                    "mesh's dcn axis is collective mode's")
            if _h.group_size(group) > 1:
                _check_local_group(cfg, group, dev)
            ps_client, hosts = _start_root(cfg, group, dev)
        _ps.reset_declare_cache()
        set_global_mesh(mesh)
        _state = _State(cfg, registry, dev, group, cfg.use_ps, ps_client,
                        dcn_group, *hosts)


def _group_tensor(vals, group, dev) -> torch.Tensor:
    """``vals`` as int64 on the device ``group``'s backend carries."""
    on = dev if dist.get_backend(group) == "nccl" else torch.device("cpu")
    return torch.tensor(vals, dtype=torch.int64, device=on)


def _check_local_group(cfg: Config, group, dev) -> None:
    """Refuse a local group whose ranks are not their BYTEPS_LOCAL_RANK
    or disagree on BYTEPS_LOCAL_SIZE, or whose size is not that value."""
    k = _h.group_size(group)
    mine = _group_tensor([cfg.local_rank, cfg.local_size], group, dev)
    every = mine.new_empty(2 * k)
    _h.all_gather(every, mine, group)
    seen = every.view(k, 2).tolist()
    if seen != [[r, k] for r in range(k)]:
        raise ValueError(
            f"PS mode with a local group of {k} processes needs each "
            "rank r of the group to run with BYTEPS_LOCAL_RANK=r and "
            f"BYTEPS_LOCAL_SIZE={k} (the launcher's --workers-per-host "
            f"{k}); the group's (BYTEPS_LOCAL_RANK, BYTEPS_LOCAL_SIZE) "
            f"are {[tuple(x) for x in seen]}")


def _start_root(cfg: Config, group, dev):
    """Local rank 0 starts the core's client. Returns (the client or
    None, (host rank, number of hosts)), the latter read by local rank 0
    and broadcast over a local group of k > 1; with one process, (0, 1),
    as ``rank()`` then reads the client itself."""
    from byteps_tpu_torch.core import ffi as _ffi
    k = _h.group_size(group)
    if k == 1 and cfg.local_size > 1:
        raise ValueError(
            f"BYTEPS_LOCAL_SIZE={cfg.local_size} but this process has no "
            "local group: initialise torch.distributed over the host's "
            "processes (or pass init(group=...)) so that one of them "
            "holds the host's PS client")
    if k == 1:
        return _ffi.Worker.start(cfg), (0, 1)
    client, hosts, err = None, [-1, -1], None
    if _h.group_rank(group) == 0:
        try:
            client = _ffi.Worker.start(cfg)
            hosts = [client.worker_rank(), client.num_workers()]
        except Exception as e:  # noqa: BLE001 (the group hears of it)
            err = e
    t = _group_tensor(hosts, group, dev)
    _h.broadcast_(t, dist.get_global_rank(group, 0), group)
    if err is not None:
        raise err
    if t[0] < 0:
        raise RuntimeError("local rank 0 of this host failed to start the "
                           "PS client (see its error)")
    return client, tuple(t.tolist())


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
        set_global_mesh(None)
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


def _hosts():
    """(this host's index, number of hosts) in PS mode: the client's live
    reading where this process holds it, else what the root read at
    init."""
    st = _st()
    if st.ps_client is not None:
        return st.ps_client.worker_rank(), st.ps_client.num_workers()
    return st.host_rank, st.num_hosts


def rank() -> int:
    """This process's index in [0, size()). PS mode: ``host_rank *
    local_size() + local_rank()``, the host's rank (DMLC_WORKER_ID order)
    read by its root's client; otherwise the ``torch.distributed`` rank
    (0 without a process group).

    One process drives one GPU here, so the reference's Horovod contract
    holds: rank and size count GPUs. The JAX ``rank()`` counts controller
    processes instead, because one JAX process drives every chip of its
    host."""
    st = _st()
    if st.ps:
        return _hosts()[0] * local_size() + _h.group_rank(st.group)
    return dist.get_rank() if dist.is_initialized() else 0


def size() -> int:
    """Number of processes: in PS mode the fleet's hosts times
    ``local_size()``, else the ``torch.distributed`` world size (1
    without a process group)."""
    st = _st()
    if st.ps:
        return _hosts()[1] * local_size()
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index among processes on the same host."""
    return _st().config.local_rank


def local_size() -> int:
    """Number of processes in the local group."""
    return _h.group_size(_st().group)


def _group_reduce(tensors, average: bool, compression: Compressor):
    """The collective levels' reduction of a list of tensors, compressed:
    int8 runs the quantized transport (``tree_quantized_all_reduce``;
    ``int8_dcn`` quantizes the dcn level too), the others their cast and
    then the hierarchical all-reduce. Returns the wire values, which
    ``compression.decompress`` takes back."""
    st = _st()
    kw = dict(ici_group=st.group, dcn_group=st.dcn_group, average=average)
    if compression.name in QUANTIZED:
        return _h.tree_quantized_all_reduce(
            tensors, quantize_dcn=compression.name == "int8_quant_dcn", **kw)
    return _h.tree_all_reduce([compression.compress(t) for t in tensors],
                              **kw)


# --- push_pull -------------------------------------------------------------

def push_pull(tensors, average: bool = True, name: Optional[str] = None,
              compression: Compressor = Compression.none):
    """Sum (or average) a tensor, list or dict of tensors across all
    workers; returns the same structure.

    The process groups reduce first (the hierarchical all-reduce), with
    the ``compression`` cast applied before and undone after; the int8
    compressors replace that transport with the quantized one. In PS mode
    the result then crosses the host boundary through the C++ KV client,
    so the reduction is global across worker processes. ``name`` keys the PS
    registry; unnamed calls share a shape-keyed name and must be issued in
    the same order on every worker. PS mode with a local group of k > 1:
    the group reduce-scatters, each rank's slices go through the host's
    root, and the group all-gathers (``ps.local_push_pull``); the int8
    transports are collective mode's there.
    """
    st = _st()
    leaves, unflatten = _h.tree_flatten(tensors)
    if not leaves:
        return tensors
    if st.ps and _h.group_size(st.group) > 1:
        from byteps_tpu_torch import ps as _ps
        if compression.name in QUANTIZED:
            raise ValueError(
                f"Compression {compression.name!r} is collective mode's "
                "transport; in PS mode use Compression.bf16/fp16")
        return unflatten(_ps.local_push_pull(
            leaves, average, name or "push_pull", compression))
    dtypes = [t.dtype for t in leaves]
    wire = _group_reduce(leaves, average, compression)
    if st.ps:
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
    if st.ps:
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


def _write_back(tensor: torch.Tensor, average: bool, name: Optional[str],
                compression: Compressor):
    out = push_pull(tensor, average=average, name=name,
                    compression=compression)
    with torch.no_grad():
        tensor.copy_(out)
    return tensor


def push_pull_async_inplace_(tensor: torch.Tensor, average: bool = True,
                             name: Optional[str] = None,
                             compression: Compressor = Compression.none
                             ) -> Handle:
    """Non-blocking push_pull of one tensor whose result is written into
    ``tensor``; ``synchronize`` of the handle waits for that and returns
    ``tensor`` (reference: byteps.torch push_pull_async_inplace_).
    ``compression`` as in ``push_pull``."""
    st = _st()
    if st.ps:
        from byteps_tpu_torch import ps as _ps
        return Handle(_ps.submit_ordered(_write_back, tensor, average, name,
                                         compression))
    return Handle(_write_back(tensor, average, name, compression))


def push_pull_inplace_(tensor: torch.Tensor, average: bool = True,
                       name: Optional[str] = None,
                       compression: Compressor = Compression.none
                       ) -> torch.Tensor:
    """Blocking push_pull of one tensor, written into ``tensor``, which is
    returned (reference: byteps.torch push_pull_inplace_)."""
    return synchronize(push_pull_async_inplace_(tensor, average, name,
                                                compression))


# --- declare / broadcast ----------------------------------------------------

def declare(name: str, tensor: torch.Tensor,
            compression_config: Optional[str] = None) -> None:
    """Pre-register ``tensor`` under ``name`` (reference: byteps.torch
    declare): ``declare_tensor`` with its shape and dtype.
    ``compression_config`` is the C-core codec of the tensors that later
    push_pull calls under ``name`` declare in PS mode, in place of the
    fleet default (``BYTEPS_COMPRESSOR``): a config string such as
    ``"type=onebit;ef=vanilla"``, or ``""`` to turn the codec off for
    this name; None leaves the default."""
    declare_tensor(name, tensor.shape, tensor.dtype)
    if compression_config is not None:
        _st().codecs[name] = compression_config


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
    ``torch.distributed`` broadcast. In PS mode it takes three stages: the
    local broadcast from ``root_rank``'s local rank, the local roots'
    broadcast through the servers from ``root_rank``'s host, and a local
    broadcast from each host's root. ``name`` keys the PS registry for
    that leg."""
    st = _st()
    leaves, _ = _h.tree_flatten(params)
    if not leaves:
        return params
    if st.ps:
        from byteps_tpu_torch import ps as _ps
        synced = _ps.local_broadcast(list(leaves), root_rank,
                                     name or "param")
    else:
        synced = _h.tree_broadcast(list(leaves), root=root_rank,
                                   ici_group=st.group,
                                   dcn_group=st.dcn_group)
    with torch.no_grad():
        for dst, src in zip(leaves, synced):
            if dst is not src:
                dst.copy_(src)
    return params


def _broadcast_blob(payload: bytes, root_rank: int, name: str) -> bytes:
    """``root_rank``'s ``payload`` on every rank: its length, then its
    bytes as a uint8 tensor, each through ``broadcast_parameters``."""
    dev = _st().device
    n = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    broadcast_parameters([n], root_rank=root_rank, name=f"{name}.len")
    buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=dev)
    if rank() == root_rank:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    broadcast_parameters([buf], root_rank=root_rank, name=f"{name}.blob")
    return buf.cpu().numpy().tobytes()


def _pickled(obj) -> bytes:
    out = io.BytesIO()
    torch.save(obj, out)
    return out.getvalue()


def _unpickled(data: bytes):
    return torch.load(io.BytesIO(data), weights_only=False)


def _materialize_state(optimizer: torch.optim.Optimizer) -> None:
    """Give ``optimizer`` its state (momentum buffers, moments, step
    counts exist only after a step) with one step of its own class on
    zero gradients, as the reference does, and then put the parameters
    and their ``.grad`` back: a decoupled weight decay (AdamW) moves the
    parameters even on a zero gradient. The step is the wrapped class's
    own, so a ``DistributedOptimizer`` does not communicate, and a
    learning-rate scheduler's wrapper is not counted."""
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.requires_grad]
    kept = [(p.detach().clone(), p.grad) for p in params]
    own = (super(_Distributed, optimizer).step
           if isinstance(optimizer, _Distributed)
           else type(optimizer).step.__get__(optimizer))
    try:
        for p in params:
            p.grad = torch.zeros_like(p)
        own()
    finally:
        with torch.no_grad():
            for p, (value, grad) in zip(params, kept):
                p.copy_(value)
                p.grad = grad


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0, name: str = "opt_state"):
    """Overwrite ``optimizer``'s state and hyperparameters in place with
    ``root_rank``'s (reference: byteps.torch broadcast_optimizer_state).

    A rank whose optimizer holds no state yet first makes it with a
    zero-gradient step that leaves the parameters as they were
    (``_materialize_state``). Every rank then holds its (parameter,
    key, shape) set of state tensors against the root's, and if any
    rank's differs, every rank raises. The state tensors come from the
    root in one ``broadcast_parameters`` call (one batched host round
    trip in PS mode); the non-tensor entries and the ``param_groups``
    (the learning rate among them) come from the root in a pickled blob.
    Pass a distinct ``name`` when broadcasting several optimizers'
    states."""
    if not optimizer.state_dict()["state"]:
        _materialize_state(optimizer)
    state = optimizer.state_dict()["state"]
    entries = sorted((pid, key) for pid, st in state.items() for key in st)
    tensors = [(pid, key) for pid, key in entries
               if torch.is_tensor(state[pid][key])
               and state[pid][key].numel() > 0]
    mine = [(pid, key, tuple(state[pid][key].shape)) for pid, key in tensors]
    root = _unpickled(_broadcast_blob(_pickled(mine), root_rank,
                                      f"{name}.keys"))
    dev = _st().device
    # how many ranks differ: a sum every rank reads, so all of them raise
    # or none; exact, so never through a lossy codec
    flag = torch.tensor([float(root != mine)], device=dev)
    declare(f"{name}.keys_differ", flag, compression_config="")
    differ = push_pull(flag, average=False, name=f"{name}.keys_differ")
    if int(differ.item()):
        raise RuntimeError(
            f"broadcast_optimizer_state: the optimizer state of "
            f"{int(differ.item())} rank(s) differs from root rank "
            f"{root_rank}'s (this rank: {len(mine)} state tensors against "
            f"the root's {len(root)}{', equal' if root == mine else ''}); "
            "give every rank the same optimizer and parameters")
    if tensors:
        live = [state[pid][key] for pid, key in tensors]
        moved = [t.to(dev) for t in live]
        broadcast_parameters(moved, root_rank=root_rank, name=name)
        with torch.no_grad():
            for t, m in zip(live, moved):
                if m is not t:
                    t.copy_(m)
    others = {(pid, key): state[pid][key] for pid, key in entries
              if not torch.is_tensor(state[pid][key])
              or state[pid][key].numel() == 0}
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in optimizer.param_groups]
    got = _unpickled(_broadcast_blob(
        _pickled({"others": others, "param_groups": groups}), root_rank,
        f"{name}.others"))
    for (pid, key), value in got["others"].items():
        state[pid][key] = value
    for group, theirs in zip(optimizer.param_groups, got["param_groups"]):
        group.update(theirs)
    return optimizer


# --- DistributedOptimizer ---------------------------------------------------

class _Distributed:
    """The methods ``DistributedOptimizer`` puts in front of the wrapped
    optimizer's class."""

    _WIRES = {"none": "float32", "bf16": "bfloat16", "fp16": "float16"}

    def _bps_setup(self, named_parameters, compression: Compressor,
                   backward_passes_per_step: int, average: bool) -> None:
        params = [p for g in self.param_groups for p in g["params"]]
        named = list(named_parameters or ())
        repeated = sorted(n for n, c in collections.Counter(
            n for n, _ in named).items() if c > 1)
        if repeated:
            raise ValueError(
                "DistributedOptimizer needs unique parameter names (pass "
                f"model.named_parameters()); repeated: {repeated}")
        self.average = average
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self.timings: dict = {}
        self._taps = None
        st = _st()
        if st.ps:
            if compression.name not in self._WIRES:
                raise ValueError(
                    f"Compression {compression.name!r} has no PS-mode "
                    f"wire; use one of {sorted(self._WIRES)}")
            from byteps_tpu_torch.overlap import _TapState
            self._taps = _TapState(
                st.ps_client, params, "grad", average, None,
                wire_dtype=self._WIRES[compression.name],
                backward_passes_per_step=backward_passes_per_step,
                sum_wire=True)
            self._taps.names.update((id(p), n) for n, p in named)

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
        # under the step trace: the synchronize span, and compute-stream
        # marks at entry and, where push_pull enqueues nothing on the
        # card (one process, no cast), at exit
        rec = self.timings
        traced = _tl.steps is not None and "spans" in rec
        if traced:
            t0 = time.perf_counter()
            _tl.mark(rec, "synchronize", self._card_stream())
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        if params:
            grads = push_pull([p.grad for p in params], average=self.average,
                              name="grad", compression=self.compression)
            for p, g in zip(params, grads):
                p.grad = g
        if traced:
            st = _st()
            if (_h.group_size(st.group) * _h.group_size(st.dcn_group) == 1
                    and self.compression.name == "none"):
                _tl.mark(rec, "synchronized", self._card_stream())
            _tl.add_span(rec, "synchronize", t0, time.perf_counter())

    def _card_stream(self):
        """The current stream of the parameters' card; None on the CPU."""
        from byteps_tpu_torch import ps as _ps
        return _ps._caller_stream([p for g in self.param_groups
                                   for p in g["params"]])

    def step(self, closure=None):
        self.synchronize()
        # under the step trace: the wrapped optimizer's update, its span
        # and a compute-stream mark after it
        rec = self.timings
        traced = _tl.steps is not None and "spans" in rec
        if traced:
            t0 = time.perf_counter()
        out = super().step(closure)
        if traced:
            _tl.add_span(rec, "update", t0, time.perf_counter())
            _tl.mark(rec, "update", self._card_stream())
        return out

    def zero_grad(self, set_to_none: bool = True) -> None:
        # under the step trace it opens the step's record (PS mode: the
        # window's, which ``timings`` then becomes), with its span and a
        # compute-stream mark at entry, the step's start
        tr = _tl.steps
        if tr is not None:
            t0 = time.perf_counter()
            ev = _tl.card_event(self._card_stream())
        if self._taps is not None:
            # a failed step may have left pushes in flight: settle them
            # and start the next window clean
            self._taps.settle()
            self._taps.reset_window()
        super().zero_grad(set_to_none=set_to_none)
        if tr is not None:
            rec = (self._taps.timeline if self._taps is not None
                   else tr.open())
            if "spans" in rec:  # else the trace stopped meanwhile
                if self._taps is None:
                    self.timings = rec
                _tl.add_span(rec, "zero_grad", t0, time.perf_counter())
                _tl.add_mark(rec, "zero_grad", ev)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression: Compressor = Compression.none,
                         backward_passes_per_step: int = 1, *,
                         average: bool = True) -> torch.optim.Optimizer:
    """Wrap a ``torch.optim.Optimizer`` so that the gradients are summed
    (mean with ``average``) across workers before its ``step()``
    (reference: byteps.torch DistributedOptimizer).

    Returns an instance of a class built here that subclasses
    ``optimizer``'s class, as the reference does, so that ``isinstance``
    checks and learning-rate schedulers work with it. The instance takes
    over ``optimizer``'s attributes (its ``param_groups``, ``defaults``
    and ``state``, shared with ``optimizer``, so a state loaded before
    wrapping is kept) without running the class's ``__init__`` again,
    which may need arguments that only the caller knows. Methods that a
    learning-rate scheduler patched onto ``optimizer`` itself are not
    taken over.

    ``named_parameters`` (``model.named_parameters()``) names the
    parameters in errors; the names must be unique.

    PS mode: a ``register_post_accumulate_grad_hook`` on each parameter
    starts its gradient's D2H copy and push the moment backward has
    accumulated it, as in ``overlap.py`` (the same ``_TapState``, prefix
    ``"grad"``), so communication overlaps the rest of backward;
    ``step()`` waits for the pulls, writes the sums into ``.grad`` and
    steps. ``compression`` (``bf16``/``fp16``) casts each gradient on the
    card, and the servers sum that dtype, as ``push_pull`` has them do
    (f32 under the fleet's codec, ``BYTEPS_COMPRESSOR``, as
    ``ps._wire_plan`` declares). Every parameter must get a gradient in
    each backward pass. ``timings`` holds the last step's pushes and the
    time the last pull was waited (host clock).

    Collective mode: ``step()`` push_pulls every ``.grad`` first (the JAX
    DistributedOptimizer leaves overlap there to the compiler).

    ``backward_passes_per_step`` > 1 is the reference's accumulation
    contract: gradients accumulate in ``.grad`` over that many backward
    passes and are communicated once (PS mode: from the hook of the last
    pass). Dividing by the count is the caller's, as in the JAX
    DistributedOptimizer; the reference plugin divides in its hook.
    """
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    if isinstance(optimizer, _Distributed):
        raise ValueError("the optimizer is a DistributedOptimizer already")
    base = type(optimizer)
    cls = type(base.__name__, (_Distributed, base), {})
    dopt = cls.__new__(cls)
    dopt.__dict__.update({k: v for k, v in vars(optimizer).items()
                          if not callable(getattr(base, k, None))})
    dopt._bps_setup(named_parameters, compression,
                    backward_passes_per_step, average)
    return dopt
