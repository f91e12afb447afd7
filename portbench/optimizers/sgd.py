"""SGD with momentum, as ``torch.optim.SGD`` defines it (no dampening,
no Nesterov, no weight decay unless given)."""

from __future__ import annotations

import torch


def program(params, hp) -> torch.optim.Optimizer:
    return torch.optim.SGD(params, lr=hp["lr"], momentum=hp["momentum"],
                           weight_decay=hp.get("weight_decay", 0.0))


@torch.no_grad()
def step(params: dict, grads: dict, state: dict, hp, t: int) -> None:
    """Step ``t`` (from 1) of every parameter in place."""
    for name, p in params.items():
        g = grads[name]
        if hp.get("weight_decay", 0.0):
            g = g + hp["weight_decay"] * p
        buf = state.get(name)
        if buf is None:
            buf = state[name] = g.clone()
        else:
            buf.mul_(hp["momentum"]).add_(g)
        p.add_(buf, alpha=-hp["lr"])


def first_grad(opt_state: dict, hp) -> torch.Tensor:
    """After one step the momentum buffer is the gradient (with its
    weight decay term, 0 here)."""
    return opt_state["momentum_buffer"]
