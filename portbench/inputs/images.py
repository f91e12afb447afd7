"""Images from N(0, 1), NCHW f32, and labels drawn uniformly from the
classes: (images [batch, 3, size, size], labels [batch]) a batch."""

from __future__ import annotations

import torch

from portbench.reference import sub_seed


def pool(cfg, traffic, seed: int, device) -> list:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 3))
    n, b, s = traffic["pool"], traffic["batch"], cfg["image_size"]
    images = torch.randn((n, b, 3, s, s), generator=gen, device=device)
    labels = torch.randint(0, cfg["num_classes"], (n, b), generator=gen,
                           device=device)
    return list(zip(images.unbind(0), labels.unbind(0)))


def rows(batch, n: int):
    return batch[0][:n], batch[1][:n]


def samples(batch) -> int:
    return batch[1].shape[0]
