"""Device choice for the port's entry points (no ``riggs_tpu`` counterpart).

Entry points that create tensors take ``device=None``, which means the card.
There is no silent CPU fallback: without CUDA they raise unless the caller
passes ``device="cpu"``, as the CPU tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA is asked for and absent.

    On CUDA it also turns TF32 off for matmuls and convolutions: the port is
    held to the reference's exact-f32 path, and TF32 keeps ~3 decimal digits.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
