"""Cells cut to a size the CPU runs in seconds, for the tests: every
width and depth shrunk, the traffic's batch with them; the code paths,
limits and metrics are the cell's own."""

import dataclasses

from portbench import cell as cells

GPT2 = dict(n_layer=2, n_embd=32, n_head=2, vocab_size=64, n_positions=16,
            n_ctx=16)
RESNET = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=10,
              image_size=32)


def tiny(name: str, **cfg):
    c = cells.load(name)
    small = GPT2 if c.cfg["model"] == "gpt2" else RESNET
    traffic = dict(c.traffic, batch=4 if c.cfg["model"] == "gpt2" else 8)
    if "seq" in traffic:
        traffic["seq"] = small["n_positions"]
    return dataclasses.replace(c, cfg={**c.cfg, **small, **cfg},
                               traffic=traffic)
