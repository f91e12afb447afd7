"""Model FLOP utilisation (%): the model's operations a training step
(``reference.<model>.train_flops``, counted from the shapes, recomputed
work not counted) over the mean host time of the traced window's steps,
over the H100's 989 TFLOP/s of dense bf16."""

import statistics

from portbench.program import modules
from portbench.roofline import PEAK_OPS


def read(rec):
    cell = rec["cell"]
    flops = modules(cell)[0].train_flops(cell.cfg, cell.traffic)
    step_s = statistics.fmean(s["end"] - s["start"] for s in rec["steps"])
    return 100.0 * flops / step_s / PEAK_OPS["bfloat16"]
