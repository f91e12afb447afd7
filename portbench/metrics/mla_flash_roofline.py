"""Share of its roofline that latent attention's three flash launches a
layer take at the cell's shape (%): forward with lse, dQ and dK/dV at
head dims (nope + rope, v), 192 and 128 for DeepSeek-V3, causal; the
least time the chip could take for them (``roofline_mla.bound_ms``:
operations and bytes from the shapes against 989 TFLOP/s and 3.35 TB/s)
over their device time, by CUDA-graph replays in turns
(``clock.time_alternating``) of the port's kernels on inputs drawn from
the run's seed. None where the model has no latent attention or runs no
flash attention."""

import importlib

import torch

from portbench.clock import time_alternating
from portbench.reference import sub_seed
from portbench.roofline_mla import bound_ms

KERNELS = ("fwd_lse", "bwd_dq", "bwd_dkv")


def read(rec):
    cell = rec["cell"]
    cfg = cell.cfg
    if cfg.get("attention") != "flash" or "qk_rope_head_dim" not in cfg:
        return None
    fa = importlib.import_module("byteps_tpu_torch.ops.flash_attention")
    b, s = cell.traffic["batch"], cell.traffic["seq"]
    h = cfg["num_attention_heads"]
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    dtype = cfg["compute_dtype"]
    gen = torch.Generator(device="cuda").manual_seed(
        sub_seed(rec["seed"], 4))

    def draw(d):
        return torch.randn((b, s, h, d), generator=gen,
                           device="cuda").to(getattr(torch, dtype))
    q, k, v, do = draw(dqk), draw(dqk), draw(dv), draw(dv)
    scale = dqk ** -0.5
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    dvec = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, dvec, True, scale)
    times = time_alternating({
        "fwd_lse": lambda: fa.flash_fwd(q, k, v, True, scale),
        "bwd_dq": lambda: fa.flash_bwd_dq(*args),
        "bwd_dkv": lambda: fa.flash_bwd_dkv(*args)}, iters=5)
    bounds = {n: bound_ms(n, b, h, s, s, dqk, dv, q.element_size(), True,
                          dtype)[0] for n in KERNELS}
    rec["log"]("latent attention's flash kernels (ms, median of 5 "
               "windows; bound): " + repr(
                   {n: (times[n], bounds[n]) for n in KERNELS}))
    return 100.0 * sum(bounds.values()) / sum(times[n][0] for n in KERNELS)
