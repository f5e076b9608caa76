"""Device resolution for the port's entry points.

Entry points take an explicit ``device``. Without one they run on the GPU,
and raise where CUDA is absent: nothing moves to the CPU silently.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. Raises RuntimeError for a CUDA device when
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def make_generator(device: torch.device, seed: Optional[int]) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (or the
    generator's default seed when None)."""
    gen = torch.Generator(device=device)
    if seed is not None:
        gen.manual_seed(int(seed))
    return gen
