"""Device picker: entry points run on the card unless the caller asks for
the CPU.  There is no silent fallback -- a missing card raises."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def pick_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card (``cuda``); raise when there is none.  Any
    explicit device (``"cpu"``, ``"cuda:1"``) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev
