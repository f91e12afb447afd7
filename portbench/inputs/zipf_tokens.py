"""Token ids drawn from a Zipf law over the vocabulary: [batch, seq] a
batch. Rank r (from 1) has probability proportional to r^-a, with a the
traffic's ``zipf_exponent`` (1.0: natural text's law); the ranks are
mapped onto the ids by a permutation drawn from the seed, so the
frequent ids are spread over the vocabulary. Repeated tokens make the
routing of an expert layer uneven, which a dropless layer must carry."""

from __future__ import annotations

import torch

from portbench.reference import sub_seed


def pool(cfg, traffic, seed: int, device) -> list:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    v = cfg["vocab_size"]
    n, b, s = traffic["pool"], traffic["batch"], traffic["seq"]
    ranks = torch.arange(1, v + 1, device=device, dtype=torch.float64)
    law = ranks.pow(-traffic["zipf_exponent"]).float()
    ids = torch.randperm(v, generator=gen, device=device)
    drawn = torch.multinomial(law, n * b * s, replacement=True,
                              generator=gen)
    return list(ids[drawn].view(n, b, s).unbind(0))


def rows(batch, n: int):
    return batch[:n]


def samples(batch) -> int:
    return batch.shape[0]
