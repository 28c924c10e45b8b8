"""Scene loading dispatch: pick the reader from the source directory's files.

Port of ``riggs_tpu/data/scene.py``, the same files in the same order:
``transforms_train.json`` a Blender / D-NeRF scene, ``train/cameras.pkl``
ZJU-MoCap, ``dataset.json`` nerfies, ``sparse/`` or ``colmap_sparse/``
COLMAP, ``cameras_sphere.npz`` DTU, ``poses_bounds.npy`` Plenoptic video,
``train_meta.json`` CMU Panoptic. No layout falls back to another.
"""
from __future__ import annotations

from pathlib import Path

from riggs_tpu_torch.data.dataset import SceneData


def load_scene(source_path: str | Path, white_background: bool = False, resolution: int = 1, **kwargs) -> SceneData:
    """The scene at ``source_path``; ``kwargs`` go to the reader (``device``
    among them)."""
    p = Path(source_path)
    if (p / "transforms_train.json").exists():
        from riggs_tpu_torch.data.blender import load_blender_scene

        return load_blender_scene(p, white_background=white_background, resolution=max(resolution, 1), **kwargs)
    if (p / "train" / "cameras.pkl").exists():
        from riggs_tpu_torch.data.zju import load_zju_scene

        return load_zju_scene(p, white_background=white_background, **kwargs)
    if (p / "dataset.json").exists():
        from riggs_tpu_torch.data.nerfies import load_nerfies_scene

        return load_nerfies_scene(p, white_background=white_background, **kwargs)
    if (p / "sparse").exists() or (p / "colmap_sparse").exists():
        from riggs_tpu_torch.data.colmap import load_colmap_scene

        return load_colmap_scene(p, resolution=max(resolution, 1), **kwargs)
    if (p / "cameras_sphere.npz").exists():
        from riggs_tpu_torch.data.more_readers import load_dtu_scene

        return load_dtu_scene(p, white_background=white_background, **kwargs)
    if (p / "poses_bounds.npy").exists():
        from riggs_tpu_torch.data.more_readers import load_plenoptic_scene

        return load_plenoptic_scene(p, white_background=white_background, **kwargs)
    if (p / "train_meta.json").exists():
        from riggs_tpu_torch.data.more_readers import load_cmu_scene

        return load_cmu_scene(p, white_background=white_background, **kwargs)
    raise FileNotFoundError(f"could not infer scene type for {source_path}")
