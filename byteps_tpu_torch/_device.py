"""Device choice shared by the port's entry points: the card unless the
caller asks for another device, and no silent CPU path."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(
        device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device``, or the default CUDA device when it is None; raises when
    a CUDA device is asked for and CUDA is not available, or when the
    device asked for does not exist.

    The default is ``cuda:<BYTEPS_LOCAL_RANK>`` when the launcher runs
    more than one worker process on the host (``BYTEPS_LOCAL_SIZE`` > 1:
    one process drives one GPU), else the current CUDA device."""
    if device is None and int(os.environ.get("BYTEPS_LOCAL_SIZE") or 1) > 1:
        device = f"cuda:{int(os.environ.get('BYTEPS_LOCAL_RANK') or 0)}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} does not exist: this host has "
                f"{torch.cuda.device_count()} CUDA device(s); pass the "
                "device each process drives")
    return dev
