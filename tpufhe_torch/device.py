"""Where the port runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    None means the CUDA card; with no card this raises instead of falling
    back. Only an explicit device="cpu" runs on the CPU (the plain torch
    versions of the kernels).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpufhe_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
