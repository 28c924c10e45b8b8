"""Device choice for the port's entry points (no ``riggs_tpu`` counterpart).

Entry points that create tensors take ``device=None``, which means the card.
There is no silent CPU fallback: without CUDA they raise unless the caller
passes ``device="cpu"``, as the CPU tests do.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _constant(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # usable by autograd wherever it was first asked for
        return torch.tensor(value, dtype=dtype, device=device)


def constant(value: float | tuple, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a tensor of ``like``'s dtype on ``like``'s device, made
    once per (value, dtype, device) and shared: never write into it.

    ``torch.maximum`` and friends take no python scalar, and a fresh
    ``new_tensor`` is a host-to-device copy that blocks the host until the
    stream drains, on every call of the render and training paths."""
    return _constant(value, like.dtype, like.device)


@functools.lru_cache(maxsize=None)
def static_index(values: tuple, device: torch.device) -> torch.Tensor:
    """A fixed int64 index (a tree's parents, one depth level's joints) on
    ``device``, made once: indexing a tensor on the card with a list or a
    numpy array copies the index over, and waits, on every call."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.int64, device=device)


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
