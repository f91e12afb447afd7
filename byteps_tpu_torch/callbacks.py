"""Horovod/Keras-style training callbacks for PyTorch training loops.

Counterpart of ``byteps_tpu/callbacks.py`` (the reference's keras plugin:
``BroadcastGlobalVariablesCallback``, ``MetricAverageCallback``,
``LearningRateWarmupCallback``), with the same names and semantics. A
loop drives them through the small ``CallbackList`` protocol
(on_train_begin / on_epoch_end / on_batch_end) over its mutable state
dict, or uses ``warmup_schedule`` directly.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

import byteps_tpu_torch as bps


class Callback:
    """Protocol: a training loop calls these around its epochs/batches.
    ``state`` is the loop's mutable dict (model, optimizer, metrics...)."""

    def on_train_begin(self, state: Dict[str, Any]) -> None: ...
    def on_epoch_begin(self, epoch: int, state: Dict[str, Any]) -> None: ...
    def on_epoch_end(self, epoch: int, state: Dict[str, Any]) -> None: ...
    def on_batch_end(self, batch: int, state: Dict[str, Any]) -> None: ...


class CallbackList(Callback):
    def __init__(self, callbacks: List[Callback]):
        self._cbs = list(callbacks)

    def on_train_begin(self, state):
        for cb in self._cbs:
            cb.on_train_begin(state)

    def on_epoch_begin(self, epoch, state):
        for cb in self._cbs:
            cb.on_epoch_begin(epoch, state)

    def on_epoch_end(self, epoch, state):
        for cb in self._cbs:
            cb.on_epoch_end(epoch, state)

    def on_batch_end(self, batch, state):
        for cb in self._cbs:
            cb.on_batch_end(batch, state)


class BroadcastGlobalVariablesCallback(Callback):
    """At train begin, overwrite every worker's weights with
    ``root_rank``'s: ``state["model"]``'s ``state_dict()`` (or
    ``state["params"]``, a tensor, list or dict of tensors), then
    ``state["optimizer"]``'s state and hyperparameters through
    ``broadcast_optimizer_state`` (a rank that has not stepped yet gets
    its state first). Everything is overwritten in place."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, state):
        if state.get("model") is not None:
            bps.broadcast_parameters(state["model"].state_dict(),
                                     root_rank=self.root_rank)
        elif state.get("params") is not None:
            bps.broadcast_parameters(state["params"],
                                     root_rank=self.root_rank)
        if state.get("optimizer") is not None:
            bps.broadcast_optimizer_state(state["optimizer"],
                                          root_rank=self.root_rank)


class MetricAverageCallback(Callback):
    """Average ``state['metrics']`` across all workers at epoch end
    (reference: keras MetricAverageCallback). Each process holds a local
    value, as in Horovod: in collective mode the mean is taken over the
    process group, in PS mode through the servers (tensors
    ``metric_avg``)."""

    def on_epoch_end(self, epoch, state):
        metrics = state.get("metrics")
        if not metrics:
            return
        keys = sorted(metrics)
        vals = torch.tensor([float(metrics[k]) for k in keys],
                            dtype=torch.float32, device=bps.device())
        vals = bps.push_pull(vals, average=True, name="metric_avg")
        state["metrics"] = {k: float(v) for k, v in zip(keys, vals.cpu())}


class LearningRateWarmupCallback(Callback):
    """Horovod-style LR warmup: scale from ``initial_lr`` to
    ``initial_lr * multiplier`` over ``warmup_epochs``. The loop reads
    ``state['lr']`` each step (or use ``warmup_schedule``)."""

    def __init__(self, initial_lr: float, multiplier: float,
                 warmup_epochs: int = 5, steps_per_epoch: int = 1,
                 verbose: bool = False):
        self.initial_lr = initial_lr
        self.multiplier = multiplier
        self.warmup_epochs = warmup_epochs
        self.steps_per_epoch = steps_per_epoch
        self.verbose = verbose
        self._batches = 0

    def _lr(self) -> float:
        total = max(1, self.warmup_epochs * self.steps_per_epoch)
        frac = min(1.0, self._batches / total)
        return self.initial_lr * (1.0 + frac * (self.multiplier - 1.0))

    def on_train_begin(self, state):
        state["lr"] = self._lr()

    def on_batch_end(self, batch, state):
        self._batches += 1
        state["lr"] = self._lr()
        if self.verbose and self._batches % self.steps_per_epoch == 0:
            print(f"warmup lr -> {state['lr']:.6f}")


class MonitorCallback(Callback):
    """Publish per-step training telemetry to the live monitor endpoint
    (byteps_tpu_torch.monitor, docs/monitoring.md): step counter, step
    time, wire-byte deltas, and, with the C core loaded, queue depth and
    credit occupancy. The numbers ride the same ``/metrics`` page as the
    C core's per-stage counters.

    The loop provides ``state['batch_size']`` (items per global step)
    for items/sec; without it only step timing and wire bytes are
    published. A summary dict also lands in ``state['monitor']`` each
    batch for in-loop consumers (loggers, progress bars)."""

    def __init__(self, batch_size: Optional[int] = None):
        self.batch_size = batch_size
        self._last_t: Optional[float] = None
        self._last_wire = (0, 0)
        self._steps = 0

    @staticmethod
    def _core_snapshot() -> dict:
        """The C core's metrics, or {} when it is not loaded (collective
        mode): the core is never built just to report zero bytes."""
        from byteps_tpu_torch.core import ffi
        return ffi.metrics_snapshot() if ffi._lib is not None else {}

    @staticmethod
    def _wire_bytes(snap: dict) -> tuple:
        van = snap.get("van", {})
        return (int(van.get("sent_bytes", 0)), int(van.get("recv_bytes", 0)))

    def on_train_begin(self, state):
        self._last_t = time.perf_counter()
        self._last_wire = self._wire_bytes(self._core_snapshot())

    def on_batch_end(self, batch, state):
        from byteps_tpu_torch.monitor import inc_counter, set_gauge

        now = time.perf_counter()
        dt = now - (self._last_t or now)
        self._last_t = now
        self._steps += 1
        snap = self._core_snapshot()
        sent, recv = self._wire_bytes(snap)
        d_sent = sent - self._last_wire[0]
        d_recv = recv - self._last_wire[1]
        self._last_wire = (sent, recv)

        inc_counter("bps_train_steps_total")
        set_gauge("bps_step_seconds", dt)
        set_gauge("bps_step_wire_sent_bytes", d_sent)
        set_gauge("bps_step_wire_recv_bytes", d_recv)
        report = {"step": self._steps, "step_seconds": dt,
                  "wire_sent_bytes": d_sent, "wire_recv_bytes": d_recv}
        batch_size = self.batch_size or state.get("batch_size")
        if batch_size and dt > 0:
            ips = batch_size / dt
            set_gauge("bps_examples_per_sec", ips)
            report["examples_per_sec"] = ips
        if snap:
            q = snap.get("queue", {})
            report["queue_pending"] = int(q.get("pending", 0))
            report["credit_inflight_bytes"] = int(q.get("inflight_bytes", 0))
        state["monitor"] = report


def warmup_schedule(base_lr: float, multiplier: Optional[float] = None,
                    warmup_steps: int = 1000):
    """A ``step -> lr`` function: linear warmup from ``base_lr`` to
    ``base_lr * multiplier`` (default: the number of workers,
    ``bps.size()``, Horovod's 'scale lr by workers' recipe), constant
    after. Use it with ``torch.optim.lr_scheduler.LambdaLR`` as
    ``lambda s: schedule(s) / base_lr``."""

    def schedule(step):
        mult = multiplier if multiplier is not None else float(
            bps.size() if bps.initialized() else 1)
        frac = min(1.0, step / max(1, warmup_steps))
        return base_lr * (1.0 + frac * (mult - 1.0))

    return schedule
