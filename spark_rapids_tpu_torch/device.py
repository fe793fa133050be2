"""Where the port's entry points run.

Entry points take an explicit `device`. `None` means the CUDA card: the
port is built for it, and a caller who wants the CPU says so. When no CUDA
device is present, `None` and "cuda" raise instead of carrying on quietly
on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None
            ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev
