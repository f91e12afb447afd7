"""The system under test as a user drives it: the port's model, the
wrapped optimizer ``bps.DistributedOptimizer(torch.optim.<Opt>(...),
named_parameters=...)``, and the loop ``zero_grad``, loss, ``backward``,
``step``, then the loss read back.

One ``Program`` is built in set-up from the seed, driven through its
first steps (the ones the reference follows) and handed to the window as
it is.
"""

from __future__ import annotations

import importlib
import time

import torch

from portbench.reference import make_weights


def modules(cell):
    """(reference, inputs, optimizer, builder) modules the cell's
    configuration and traffic name."""
    cfg, traffic = cell.cfg, cell.traffic
    return (importlib.import_module(f"portbench.reference.{cfg['model']}"),
            importlib.import_module(f"portbench.inputs.{cfg['inputs']}"),
            importlib.import_module(
                f"portbench.optimizers.{traffic['optimizer']['name']}"),
            importlib.import_module(f"portbench.models.{cfg['model']}"))


class Program:
    """The model, its ``DistributedOptimizer`` and the batch pool of one
    run. ``fault`` plants one of the faults the comparison must catch
    (the benchmark's runs never set it): ``half_batch`` takes the loss
    over the first half of each batch's rows, ``state_unchanged`` steps
    without changing the parameters, ``no_round_trip`` steps the plain
    optimizer on the worker's own gradients, with no push or pull."""

    def __init__(self, cell, seed: int, device, fault: str = ""):
        import byteps_tpu_torch as bps

        self.cell, self.seed, self.device = cell, seed, device
        ref, self.inputs, self.optim, builder = modules(cell)
        self.specs = ref.specs(cell.cfg)
        self.model, loss_fn = builder.build(
            cell.cfg, make_weights(self.specs, seed, device), device)
        self.pool = self.inputs.pool(cell.cfg, cell.traffic, seed, device)
        self.hp = cell.traffic["optimizer"]
        inner = self.optim.program(self.model.parameters(), self.hp)
        # the wrapped optimizer's own update, without the communication
        self.plain_step = type(inner).step
        self.opt = bps.DistributedOptimizer(
            inner, named_parameters=self.model.named_parameters(),
            compression=getattr(bps.Compression,
                                cell.traffic.get("compression", "none")))
        if fault == "half_batch":
            rows = self.inputs.rows
            self.loss_fn = lambda m, b: loss_fn(
                m, rows(b, self.inputs.samples(b) // 2))
        else:
            self.loss_fn = loss_fn
        if fault == "state_unchanged":
            self.opt.step = self.opt.synchronize
        elif fault == "no_round_trip":
            self.opt = inner
        elif fault not in ("", "half_batch"):
            raise ValueError(f"unknown fault {fault!r}")
        self.ps = cell.traffic["mode"] == "ps"
        self.steps = 0
        # traced: each step records an event on the card at its start,
        # after ``backward()`` returns and after ``step()`` returns
        self.mark = False

    def next_batch(self):
        batch = self.pool[self.steps % len(self.pool)]
        self.steps += 1
        return batch

    def step(self, sync: bool = True) -> dict:
        """One training step on the next batch of the pool. With ``sync``
        the step ends when its loss is read back (``loss``). Returns the
        host clock when the step started and when its zero_grad, forward
        (``fwd_end``), backward (``bwd_end``), optimizer step (``opt_end``)
        and loss read (``end``) returned, with the optimizer's
        ``timings``."""
        batch = self.next_batch()
        t = {"start": time.perf_counter()}
        self._mark(t, "start_event")
        self.opt.zero_grad()
        loss = self.loss_fn(self.model, batch)
        t["fwd_end"] = time.perf_counter()
        loss.backward()
        t["bwd_end"] = time.perf_counter()
        self._mark(t, "bwd_event")
        self.opt.step()
        t["opt_end"] = time.perf_counter()
        self._mark(t, "end_event")
        t["loss"] = loss.item() if sync else loss.detach()
        t["end"] = time.perf_counter()
        t["timings"] = getattr(self.opt, "timings", {})
        t["samples"] = self.inputs.samples(batch)
        return t

    def _mark(self, t: dict, name: str):
        """With ``mark``, an event recorded now, read after the window:
        where the card is in the step."""
        if self.mark:
            t[name] = torch.cuda.Event(enable_timing=True)
            t[name].record()

    def first_steps(self, n: int = 3) -> dict:
        """The first ``n`` steps, the ones the reference follows: each
        step's loss, each leaf's norm of the first gradient as the
        optimizer got it (worked out from its state after one step), and
        each leaf's norm of the parameters' change over the ``n`` steps,
        read before another step changes them; in PS mode also ``wire``,
        each step's (sent, received) bytes through the worker's PS van."""
        if self.steps:
            raise RuntimeError("first_steps must be the program's first")
        from portbench.trace import van_bytes
        named = dict(self.model.named_parameters())
        losses, grads, wire = [], {}, []
        for i in range(n):
            before = van_bytes() if self.ps else None
            losses.append(self.step()["loss"])
            if self.ps:
                after = van_bytes()
                wire.append((after[0] - before[0], after[1] - before[1]))
            if i == 0:
                # no state: the step left the parameters as they were
                grads = {name: float(self.optim.first_grad(
                    self.opt.state[p], self.hp).norm())
                    if self.opt.state.get(p) else 0.0
                    for name, p in named.items()}
        start = make_weights(self.specs, self.seed, self.device)
        with torch.no_grad():
            change = {name: float((p - start[name]).norm())
                      for name, p in named.items()}
        del start
        out = {"losses": losses, "grad_norms": grads, "change_norms": change}
        if self.ps:
            out["wire"] = wire
        return out
