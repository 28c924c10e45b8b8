"""Binary PLY codec for Gaussian clouds, in the reference's field layout.

Port of ``riggs_tpu/io/ply.py``: a float32 little-endian vertex element with
fields ``x y z nx ny nz f_dc_0..2 f_rest_0..(3R-1) opacity scale_* rot_0..3
fea_*``, where ``f_dc`` and ``f_rest`` are stored channel-major (the
reference's ``transpose(1, 2)`` layout). Both packages write the same bytes
for the same Gaussians, and each reads the other's files.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.models.gaussians import Gaussians


def write_ply(path: str | Path, arrays: dict[str, np.ndarray]):
    """Write named float32 columns as a binary_little_endian PLY vertex element."""
    n = next(iter(arrays.values())).shape[0]
    names = list(arrays)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header", ""]
    rec = np.zeros(n, dtype=[(name, "<f4") for name in names])
    for name in names:
        rec[name] = np.asarray(arrays[name], np.float32).reshape(n)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: str | Path) -> dict[str, np.ndarray]:
    """Read a float32 binary PLY vertex element into named columns."""
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    n, names, fmt = None, [], None
    for line in data[:end].decode("ascii").splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element" and parts[1] == "vertex":
            n = int(parts[2])
        elif parts[0] == "property" and len(parts) == 3:
            if parts[1] not in ("float", "float32"):
                raise ValueError(f"{path}: unsupported property type {parts[1]}")
            names.append(parts[2])
    if fmt != "binary_little_endian":
        raise ValueError(f"{path}: unsupported format {fmt}")
    rec = np.frombuffer(data[end:], dtype=[(name, "<f4") for name in names], count=n)
    return {name: np.array(rec[name]) for name in names}


def save_gaussians_ply(path: str | Path, gs: Gaussians):
    """The alive Gaussians in the reference's layout (one copy of each
    tensor to the host: call it at events, not per step)."""
    alive = gs.alive.cpu().numpy()
    host = lambda t: t.detach().cpu().numpy()[alive]
    xyz = host(gs.xyz)
    n = xyz.shape[0]
    # channel-major: (n, K, 3) -> (n, 3, K) -> flat
    f_dc = np.transpose(host(gs.features_dc), (0, 2, 1)).reshape(n, -1)
    f_rest = np.transpose(host(gs.features_rest), (0, 2, 1)).reshape(n, -1)
    cols: dict[str, np.ndarray] = {name: xyz[:, i] for i, name in enumerate("xyz")}
    for name in ("nx", "ny", "nz"):
        cols[name] = np.zeros(n, np.float32)
    cols.update({f"f_dc_{i}": f_dc[:, i] for i in range(f_dc.shape[1])})
    cols.update({f"f_rest_{i}": f_rest[:, i] for i in range(f_rest.shape[1])})
    cols["opacity"] = host(gs.opacity)[:, 0]
    scaling = host(gs.scaling)
    cols.update({f"scale_{i}": scaling[:, i] for i in range(scaling.shape[1])})
    rot = host(gs.rotation)
    cols.update({f"rot_{i}": rot[:, i] for i in range(4)})
    feat = host(gs.feature)
    cols.update({f"fea_{i}": feat[:, i] for i in range(feat.shape[1])})
    write_ply(path, cols)


def _numbered(cols: dict, prefix: str) -> list[str]:
    return sorted((k for k in cols if k.startswith(prefix)), key=lambda s: int(s.split("_")[-1]))


def load_gaussians_ply(
    path: str | Path,
    capacity: int | None = None,
    max_sh_degree: int = 3,
    isotropic: bool = False,
    with_motion_mask: bool = True,
    device: str | torch.device | None = None,
) -> Gaussians:
    """A reference-layout PLY as capacity-padded ``Gaussians`` on ``device``
    (``cuda`` unless told otherwise): the file's rows first and alive, the
    rest zero with identity rotations. ``capacity`` defaults to the next
    power of two."""
    dev = resolve_device(device)
    cols = read_ply(path)
    n = cols["x"].shape[0]
    capacity = max(capacity or 1 << (n - 1).bit_length(), n)

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], -1)
    f_dc = np.stack([cols[k] for k in _numbered(cols, "f_dc_")], -1).reshape(n, 3, 1).transpose(0, 2, 1)
    rest = _numbered(cols, "f_rest_")  # none at SH degree 0, where the reference's reader fails
    f_rest = np.stack([cols[k] for k in rest], -1) if rest else np.zeros((n, 0), np.float32)
    f_rest = f_rest.reshape(n, 3, len(rest) // 3).transpose(0, 2, 1)
    scaling = np.stack([cols[k] for k in _numbered(cols, "scale_")], -1)
    if isotropic:
        scaling = scaling[:, :1]
    rot = np.stack([cols[f"rot_{i}"] for i in range(4)], -1)
    fea = _numbered(cols, "fea_")
    feat = np.stack([cols[k] for k in fea], -1) if fea else np.zeros((n, 0), np.float32)

    def pad(a):
        out = np.zeros((capacity,) + a.shape[1:], np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(dev)

    rot_pad = np.tile(np.array([1, 0, 0, 0], np.float32), (capacity, 1))
    rot_pad[:n] = rot
    return Gaussians(
        xyz=pad(xyz), features_dc=pad(f_dc), features_rest=pad(f_rest), scaling=pad(scaling),
        rotation=torch.from_numpy(rot_pad).to(dev), opacity=pad(cols["opacity"][:, None]), feature=pad(feat),
        alive=(torch.arange(capacity) < n).to(dev),
        max_sh_degree=max_sh_degree, isotropic=isotropic, with_motion_mask=with_motion_mask and feat.shape[1] > 0,
    )
