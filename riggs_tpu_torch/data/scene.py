"""Scene loading dispatch: pick the reader from the source directory's files.

Port of ``riggs_tpu/data/scene.py``. ``transforms_train.json`` means a
Blender / D-NeRF scene (``data/blender.py``). The other layouts the
reference reads (ZJU, nerfies, COLMAP and the three of ``more_readers``)
are recognised by the same files and raise: their readers are not ported
yet (ROADMAP A8). No layout falls back to the synthetic scene.
"""
from __future__ import annotations

from pathlib import Path

from riggs_tpu_torch.data.dataset import SceneData

# file or directory -> the reference's reader, for each layout not ported yet
_NOT_PORTED = (
    ("train/cameras.pkl", "ZJU-MoCap (data/zju.py)"),
    ("dataset.json", "nerfies (data/nerfies.py)"),
    ("sparse", "COLMAP (data/colmap.py)"),
    ("colmap_sparse", "COLMAP (data/colmap.py)"),
    ("cameras_sphere.npz", "DTU (data/more_readers.py)"),
    ("poses_bounds.npy", "Plenoptic video (data/more_readers.py)"),
    ("train_meta.json", "CMU Panoptic (data/more_readers.py)"),
)


def load_scene(source_path: str | Path, white_background: bool = False, resolution: int = 1, **kwargs) -> SceneData:
    """The scene at ``source_path``; ``kwargs`` go to the reader (``device``
    among them)."""
    p = Path(source_path)
    if (p / "transforms_train.json").exists():
        from riggs_tpu_torch.data.blender import load_blender_scene

        return load_blender_scene(p, white_background=white_background, resolution=max(resolution, 1), **kwargs)
    for marker, reader in _NOT_PORTED:
        if (p / marker).exists():
            raise NotImplementedError(f"{source_path}: the {reader} reader is not ported yet (ROADMAP A8)")
    raise FileNotFoundError(f"could not infer scene type for {source_path}")
