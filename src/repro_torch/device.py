"""Device and dtype resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: without
an explicit ``device`` they take ``cuda`` and raise when there is none.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Raises ``RuntimeError`` for a CUDA device
    when CUDA is not available; pass ``device="cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ("bfloat16" | "float32" | "float16") -> dtype."""
    return _DTYPES[name]
