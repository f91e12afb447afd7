"""Share of its roofline that flash attention's three launches a layer
take at the cell's shape (%): the least time the chip could take for the
forward with lse, dQ and dK/dV (``roofline.bound_ms``: operations and
bytes from the shapes, each input read once, against 989 TFLOP/s and
3.35 TB/s) over their device time, by CUDA-graph replays in turns
(``clock.time_alternating``) of the port's kernels on inputs drawn from
the run's seed. None where the model runs no flash attention."""

import importlib
import math

import torch

from portbench.clock import time_alternating
from portbench.reference import sub_seed
from portbench.roofline import bound_ms

KERNELS = ("fwd_lse", "bwd_dq", "bwd_dkv")


def read(rec):
    cell = rec["cell"]
    cfg = cell.cfg
    if cfg.get("attention") != "flash":
        return None
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")
    b, s = cell.traffic["batch"], cell.traffic["seq"]
    h = cfg["n_head"]
    d = cfg["n_embd"] // h
    dtype = cfg["compute_dtype"]
    gen = torch.Generator(device="cuda").manual_seed(
        sub_seed(rec["seed"], 4))
    q, k, v, do = torch.randn((4, b, s, h, d), generator=gen,
                              device="cuda").to(getattr(torch, dtype))
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    dvec = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, dvec, True, scale)
    times = time_alternating({
        "fwd_lse": lambda: fa.flash_fwd(q, k, v, True, scale),
        "bwd_dq": lambda: fa.flash_bwd_dq(*args),
        "bwd_dkv": lambda: fa.flash_bwd_dkv(*args)})
    bounds = {n: bound_ms(n, b, h, s, s, d, q.element_size(), True, None,
                          dtype)[0] for n in KERNELS}
    rec["log"]("flash kernels (ms, median of 5 windows; bound): " + repr(
        {n: (times[n], bounds[n]) for n in KERNELS}))
    return 100.0 * sum(bounds.values()) / sum(times[n][0] for n in KERNELS)
