"""Where the port runs: the card unless the caller asks for the CPU.

Every entry point that takes a ``device`` (``"cuda"`` by default) passes
it through ``require_device``, which raises where the card is missing:
nothing falls back to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch


def require_device(device: Union[str, torch.device],
                   who: str) -> torch.device:
    """``device`` as a ``torch.device``; raises, naming the caller ``who``,
    where it is a card that is not there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device={str(device)!r}): no CUDA device is available; "
            f"pass device='cpu' to run on the CPU")
    return device


def device_name(device: torch.device) -> str:
    """What a report says the model ran on: the card's name, or CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "CPU"
