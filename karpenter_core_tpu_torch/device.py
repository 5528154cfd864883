"""Device resolution for the port's entry points.

``None`` means the CUDA card.  The CPU is used only when the caller asks
for it (``device="cpu"``, as the CPU tests do); with no card and no explicit
request this raises instead of running somewhere else.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the solve on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
