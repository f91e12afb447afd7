"""AdamW (Loshchilov and Hutter 2019), as ``torch.optim.AdamW`` defines
it: decoupled weight decay, then the bias-corrected Adam step."""

from __future__ import annotations

import torch


def _hp(hp):
    b1, b2 = hp.get("betas", (0.9, 0.999))
    return hp["lr"], b1, b2, hp.get("eps", 1e-8), hp.get("weight_decay", 0.0)


def program(params, hp) -> torch.optim.Optimizer:
    lr, b1, b2, eps, wd = _hp(hp)
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                             weight_decay=wd)


@torch.no_grad()
def step(params: dict, grads: dict, state: dict, hp, t: int) -> None:
    """Step ``t`` (from 1) of every parameter in place."""
    lr, b1, b2, eps, wd = _hp(hp)
    for name, p in params.items():
        g = grads[name]
        m, v = state.setdefault(name, (torch.zeros_like(p),
                                       torch.zeros_like(p)))
        p.mul_(1 - lr * wd)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def first_grad(opt_state: dict, hp) -> torch.Tensor:
    """After one step exp_avg = (1 - beta1) g."""
    return opt_state["exp_avg"] / (1 - _hp(hp)[1])
