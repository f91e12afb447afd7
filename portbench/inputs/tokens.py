"""Token ids drawn uniformly from the vocabulary: [batch, seq] a batch."""

from __future__ import annotations

import torch

from portbench.reference import sub_seed


def pool(cfg, traffic, seed: int, device) -> list:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    ids = torch.randint(0, cfg["vocab_size"],
                        (traffic["pool"], traffic["batch"], traffic["seq"]),
                        generator=gen, device=device)
    return list(ids.unbind(0))


def rows(batch, n: int):
    return batch[:n]


def samples(batch) -> int:
    return batch.shape[0]
