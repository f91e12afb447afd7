"""How far a lossy gradient wire may move SGD off its reference run, and
the check that holds a run to it. Imports no JAX: the tests on the card
and the fleet workers use it too.

A wire rounds each gradient once a step: ``bfloat16`` and ``float16`` to
nearest, within ``U[wire] * |g|`` of it (``float16`` also ``2^-25``
absolute below its least normal); ``int8`` within half a quantisation
step, ``absmax(block) / 254``, of each element of a block. SGD at rate lr
moves each parameter by ``-lr g`` a step, so before step t the run sits
within ``D_t = lr * sum_{s<t} err_s`` of the reference, to first order.
The run's gradients are taken at its own parameters, which differ from
the reference's by up to D_t: ``SLACK`` covers that second-order part.

* parameters: the run's change ``p_T - p_0`` equals the reference's to
  ``SLACK * D_T``, plus ``F32`` of the reference's steps (the two runs'
  f32 gradients sum in other orders: 2e-6 of a step seen between the
  port's and the JAX package's, and 1e-9 where a gradient is zero but
  for rounding, as a key bias's is) and the f32 rounding of T updates;
* losses: the loss before step t differs by at most ``sum |g_t| D_t``
  (first order), times ``SLACK``, plus 1e-5 of itself.

Where the reference can start each step from the run's own parameters
(the plain torch step beside the run), ``assert_step_near`` holds one
step at a time, and then no second-order part arises: the update equals
``lr g`` to ``lr err(g)``, plus ``F32`` of it and one f32 ulp of the
parameter for the update's own rounding. On the card a trajectory check does need more than ``SLACK``: an
element with a small gradient of its own moves by its coupling to the
other weights' rounding.

A wire that pushed zeros, a wrong scale or a broken re-expansion moves a
parameter by about its whole update, 2^7 (bf16) or ~2^6 (int8) times the
bound; ``tests/test_torch_overlap.py`` plants such faults and checks that
this bound fails them.
"""

import torch

U = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
SLACK = 2.0
F32 = 1e-4


def _f64(sd):
    return {k: v.detach().to("cpu", torch.float64) for k, v in sd.items()}


def snapshot(module):
    """The module's parameters as float64 tensors on the CPU."""
    return _f64(module.state_dict())


def sgd_grads(snapshots, lr):
    """The gradient each plain-SGD step applied, read from the parameters
    before and after it."""
    return [{k: (a[k] - b[k]) / lr for k in a}
            for a, b in zip(snapshots, snapshots[1:])]


def wire_error(wire, g, block=256):
    """Per element bound of |what ``wire`` delivers - g| for one flat
    gradient g of a parameter (``block``: the int8 wire's; a parameter
    smaller than it is one block, as ``overlap._TapState`` pads)."""
    g = g.reshape(-1).to(torch.float64)
    if wire == "float32":
        return torch.zeros_like(g)
    if wire in U:
        err = U[wire] * g.abs()
        return err + 2.0 ** -25 if wire == "float16" else err
    assert wire == "int8", wire
    n = g.numel()
    b = min(block, max(1, n))
    pad = -n % b
    blocks = torch.cat([g, g.new_zeros(pad)]).abs().reshape(-1, b)
    step = blocks.amax(dim=1, keepdim=True) / 127.0
    # half a step, and the f32 roundings of absmax / 127, x / step and
    # code x step (each up to 127 x 2^-24 of a step)
    return (step * (0.5 + 2.0 ** -14)).expand(-1, b).reshape(-1)[:n]


def wire_errors(wire, grads, block=256):
    """``wire_error`` of every parameter of every step, shaped as the
    parameters."""
    return [{k: wire_error(wire, g, block).reshape(g.shape)
             for k, g in step.items()} for step in grads]


def assert_near_reference(label, snapshots, got, lr, errs, losses=()):
    """Hold a run to its reference (see the module docstring).

    ``snapshots``: the reference's parameters before each of T steps and
    after the last (``snapshot``); ``got``: the run's parameters after T
    steps; ``errs``: per step, per parameter, the bound of the wire's error
    in the gradient that step applied; ``losses``: (step t, the run's
    loss, the reference's loss, the reference's gradient of that loss),
    each taken at the parameters before step t. Returns the largest share
    of its bound that a loss and that a parameter's change took."""
    steps = len(snapshots) - 1
    dev = [{k: torch.zeros_like(v) for k, v in snapshots[0].items()}]
    for err in errs:
        dev.append({k: d + lr * err[k] for k, d in dev[-1].items()})
    shares = [0.0, 0.0]
    for t, a, b, grad in losses:
        bound = 1e-5 * abs(b) + SLACK * sum(
            float((grad[k].abs() * dev[t][k]).sum()) for k in grad)
        shares[0] = max(shares[0], abs(a - b) / bound)
        assert abs(a - b) <= bound, (
            f"{label}: loss {a} before step {t} differs from the "
            f"reference's {b} by {abs(a - b):.3e} > {bound:.3e}")
    got = _f64(got)
    first, last = snapshots[0], snapshots[-1]
    for k, p0 in first.items():
        want = last[k] - p0
        diff = (got[k] - p0 - want).abs()
        moved = sum((a[k] - b[k]).abs()
                    for a, b in zip(snapshots, snapshots[1:]))
        bound = (SLACK * dev[-1][k] + F32 * moved + 1e-8 + steps * 2.0 ** -23
                 * torch.maximum(p0.abs(), last[k].abs()))
        shares[1] = max(shares[1], float((diff / bound).max()))
        worst = int(torch.argmax(diff - bound))
        assert bool((diff <= bound).all()), (
            f"{label}: the change of {k} differs from the reference's by "
            f"{float(diff.reshape(-1)[worst]):.3e} > "
            f"{float(bound.reshape(-1)[worst]):.3e} (element {worst}; the "
            f"reference moved it by {float(want.reshape(-1)[worst]):.3e})")
    return tuple(shares)


def assert_step_near(label, before, after, grad, lr, wire, block=256):
    """Hold one SGD step of a run to plain SGD from the same parameters:
    ``before`` and ``after`` are the run's parameters around the step
    (state dicts), ``grad`` the plain gradient at ``before`` (by name).
    Returns the largest share of the bound that a parameter took."""
    b, a = _f64(before), _f64(after)
    share = 0.0
    for k, g in grad.items():
        g = g.detach().to("cpu", torch.float64)
        diff = (b[k] - a[k] - lr * g).abs()
        bound = (lr * (wire_error(wire, g, block).reshape(g.shape)
                       + F32 * g.abs()) + 2.0 ** -23 * a[k].abs() + 1e-12)
        share = max(share, float((diff / bound).max()))
        worst = int(torch.argmax(diff - bound))
        assert bool((diff <= bound).all()), (
            f"{label}: the step moved {k} off lr * its plain gradient by "
            f"{float(diff.reshape(-1)[worst]):.3e} > "
            f"{float(bound.reshape(-1)[worst]):.3e} (element {worst}; the "
            f"plain step moves it by "
            f"{float(lr * g.reshape(-1)[worst]):.3e})")
    return share
