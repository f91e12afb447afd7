"""Share of its roofline that the held experts' grouped SwiGLU products
take (%), forward and backward, at the rows a held expert got a step:
the step trace's ``moe_rows`` (the pairs the step's expert layers routed
to the held experts, summed on the card) over the expert layers and the
held experts, an even split of them to each. The six grouped products of
a layer (gate and up as one, down; the backward's input and weight
gradients of both: ``parallel.moe._grouped``, ``torch._grouped_mm`` with
device-side offsets) on bf16 inputs drawn from the run's seed, timed by
CUDA events over eager calls (their backward does not capture into a CUDA
graph); the bound is 3 x 2 x 3 x d x dim operations a routed row at 989
TFLOP/s, or their bytes (each input read once, each output written once)
at 3.35 TB/s, whichever is larger. None where the program's step trace
counts no routed rows."""

import statistics

import torch

from portbench.reference import sub_seed
from portbench.roofline import HBM_BPS, PEAK_OPS
from portbench.steps import recorded

WINDOWS, ITERS = 5, 10


def bound_ms(rows: int, held: int, d: int, f: int, elem: int, dtype: str):
    """(least ms, "bytes" or "operations") of the six products over
    ``rows`` routed rows."""
    ops = 3 * 2 * 3 * d * f * rows
    w1, w2 = held * d * 2 * f, held * f * d  # elements
    x, h, a, y = rows * d, rows * 2 * f, rows * f, rows * d
    elems = ((x + w1 + h) + (a + w2 + y)        # forward
             + (h + w1 + x) + (x + h + w1)      # dX, dW1
             + (y + w2 + a) + (a + y + w2))     # dA, dW2
    t_bytes = elems * elem / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def read(rec):
    out = recorded(rec)
    rows = [r["moe_rows"] for r in (out["records"] if out else ())
            if r.get("moe_rows")]
    if not rows:
        return None
    from byteps_tpu_torch.parallel.moe import _grouped
    cfg = rec["cell"].cfg
    held, d = cfg["n_routed_experts"], cfg["hidden_size"]
    f = cfg["moe_intermediate_size"]
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    per = max(1, round(statistics.fmean(rows) / (layers * held)))
    n = per * held
    dtype = getattr(torch, cfg["compute_dtype"])
    gen = torch.Generator(device="cuda").manual_seed(
        sub_seed(rec["seed"], 5))

    def draw(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(dtype).requires_grad_()
    xs, a = draw(n, d), draw(n, f)
    w1, w2 = draw(held, d, 2 * f, std=0.006), draw(held, f, d, std=0.006)
    dh, dy = draw(n, 2 * f).detach(), draw(n, d).detach()
    offs = torch.arange(1, held + 1, device="cuda",
                        dtype=torch.int32) * per

    def products():
        h = _grouped(xs, w1, offs)
        y = _grouped(a, w2, offs)
        torch.autograd.grad((h, y), (xs, w1, a, w2), (dh, dy))
    for _ in range(3):
        products()
    times = []
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(ITERS):
            products()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / ITERS)
    ms = statistics.median(times)
    bound, by = bound_ms(n, held, d, f, xs.element_size(),
                         cfg["compute_dtype"])
    rec["log"](f"held experts' grouped products: {per} rows an expert "
               f"({statistics.fmean(rows)} routed rows a step), {ms} ms "
               f"(windows {times}), bound {bound} ms by {by}")
    return 100.0 * bound / ms
