"""Device choice shared by the port's entry points: the card unless the
caller asks for another device, and no silent CPU path."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(
        device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device``, or the current CUDA device when it is None; raises when
    a CUDA device is asked for and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
