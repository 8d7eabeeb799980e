"""Device resolution shared by every entry point of the port.

Entry points (``Fabric``, ``ModelEngine``, ``ElasticServer``,
``Shell.fabric``) run on ``"cuda"`` unless the caller asks for the CPU.
Without a card and without an explicit CPU request they raise: nothing
quietly carries on on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card; ``"cpu"`` must be asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

