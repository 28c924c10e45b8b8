"""Point-to-segment distances, Procrustes rotation fits, a safe norm.

Port of ``riggs_tpu/ops/geometry.py``: ``point_segment_dist2`` (bone
skinning), ``fit_rotations`` (the ARAP losses), ``safe_norm`` and the
homogeneous-coordinate pair ``to_homogeneous`` / ``from_homogeneous``.

``fit_rotations`` is a hand kernel on the card (``csrc/rotfit.cu``: one
thread per 3x3 matrix, a Jacobi eigen-decomposition of cov^T cov in f64),
because ``torch.linalg.svd`` there checks its convergence flags on the host,
two blocking reads a call. On a CPU tensor it runs its plain version,
``fit_rotations_plain`` (the SVD); on a CUDA tensor it launches the kernel
or raises. No backward: the ARAP losses detach the rotations. The same
library holds the fused fit that ``ops/arap.py:estimate_rotations``
launches (the covariance built from the edges in the same kernel); both
wrappers count their launches in ``launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from riggs_tpu_torch import cuda_build

CSRC = cuda_build.CSRC_DIR / "rotfit.cu"
LIB_STEM = "libriggs_rotfit"

# launches of the kernel since the last reset_launches(); the wrapper adds
# one where it launches it and nowhere else
launches = {"fit_rotations": 0, "estimate_rotations": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def point_segment_dist2(a: torch.Tensor, b: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Squared distance from each point (N, D) to each segment [a_j, b_j]
    (a, b: (K, D)). Returns (N, K)."""
    ab = b - a
    denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-6)
    ap = points[:, None, :] - a[None, :, :]
    t = torch.sum(ap * ab[None], dim=-1) / denom
    t = torch.clamp(t, 0.0, 1.0)
    closest = a[None] + t[..., None] * ab[None]
    diff = closest - points[:, None, :]
    return torch.sum(diff * diff, dim=-1)


def fit_rotations_plain(cov: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fit_rotations``: with cov = U S V^T, R = U diag(1,
    1, det(U V^T)) V^T (det(R) = +1). R does not depend on the signs the
    SVD gives its singular vectors."""
    u, _, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    d = torch.cat([torch.ones_like(det)[..., None].expand(*det.shape, 2), det[..., None]], dim=-1)
    return torch.einsum("...ab,...b,...bc->...ac", u, d, vt)


# the debug build (csrc/rotfit.cu): both kernels also write each fit's
# Jacobi sweeps where riggs_rotfit_sweeps_to points; no wrapper loads it
DEBUG_STEM, DEBUG_DEFINES = "libriggs_rotfit_sweeps", ("ROTFIT_COUNT_SWEEPS",)


@functools.lru_cache(maxsize=None)
def load_library(debug: bool = False) -> ctypes.CDLL:
    """Build ``csrc/rotfit.cu`` for sm_90a (once per source version) and
    load it; with ``debug``, its sweep-counting build instead."""
    lib = cuda_build.load(CSRC, DEBUG_STEM, DEBUG_DEFINES) if debug else cuda_build.load(CSRC, LIB_STEM)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.riggs_fit_rotations.argtypes = [p, p, i32, p]
    lib.riggs_fit_rotations.restype = i32
    lib.riggs_estimate_rotations.argtypes = [p, i64, p, i64, p, i64, p, i64, p, i64, i32, i32, p, p]
    lib.riggs_estimate_rotations.restype = i32
    lib.riggs_rotfit_empty.argtypes = [p]
    lib.riggs_rotfit_empty.restype = i32
    if debug:
        lib.riggs_rotfit_sweeps_to.argtypes = [p]
        lib.riggs_rotfit_sweeps_to.restype = i32
    return lib


def launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` of the loaded library on ``device``'s current
    stream, from that device's context; returns its CUDA error code. The
    stream is read as its raw handle (``torch.cuda.current_stream`` builds a
    Stream object a call, about as much host time as the launch itself)."""
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        with torch.cuda.device(device.index):
            return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    return fn(*args, torch._C._cuda_getCurrentRawStream(current))


def build_log() -> str:
    """ptxas's report of the build ``load_library`` made or found."""
    return cuda_build.lib_path(CSRC, LIB_STEM).with_suffix(".log").read_text()


def fit_rotations(cov: torch.Tensor) -> torch.Tensor:
    """Best-fit rotations (..., 3, 3) from correlation matrices (..., 3, 3):
    the proper rotation R maximizing trace(R^T cov), R = U diag(1, 1,
    det(U V^T)) V^T for cov = U S V^T. The kernel on CUDA (float32), the
    plain version on the CPU. Where the fit is ill-posed (``csrc/rotfit.cu``
    says which rotation the kernel returns) the two may differ."""
    if cov.device.type == "cpu":
        return fit_rotations_plain(cov)
    if cov.device.type != "cuda":
        raise ValueError(f"unsupported device {cov.device}")
    if cov.dtype != torch.float32 or cov.shape[-2:] != (3, 3):
        raise ValueError(f"cov must be float32 (..., 3, 3), got {cov.dtype} {tuple(cov.shape)}")
    c = cov.contiguous()
    rot = torch.empty(c.shape, dtype=torch.float32, device=c.device)
    n = c.numel() // 9
    if n:
        err = launch(load_library().riggs_fit_rotations, c.device, c.data_ptr(), rot.data_ptr(), n)
        if err != 0:
            raise RuntimeError(f"fit_rotations launch failed: CUDA error {err}")
        launches["fit_rotations"] += 1
    return rot


def safe_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2 norm with a finite gradient at the origin: sqrt(sum x^2 + eps)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def to_homogeneous(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 4) with a trailing 1."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def from_homogeneous(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3), divided by the last coordinate."""
    return x[..., :3] / x[..., 3:4]
