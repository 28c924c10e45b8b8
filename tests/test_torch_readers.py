"""The scene readers of riggs_tpu_torch against riggs_tpu's on the same
files: COLMAP (binary and text models), nerfies, DTU, Plenoptic video and
CMU Panoptic, through both packages' load_scene.

The fixtures of the DTU, Plenoptic, CMU and nerfies scenes are copies of
the reference's own (tests/test_more_readers.py, tests/
test_hash_viewer_nerfies.py); the COLMAP scene is this file's: two camera
models, a principal point off the centre, four images, one held out.

Tolerances: init points and colours, images, masks, thinned points,
names, flags and frame counts exactly equal; camera w2c, intrinsics and
times within 1e-6 (both packages store float32 tensors of the same numpy
values); cameras_extent within 1e-6 relative.
"""
import json
import struct

import numpy as np
import pytest
from PIL import Image

from riggs_tpu.data import more_readers as JMR
from riggs_tpu.data.colmap import qvec2rotmat as j_qvec2rotmat
from riggs_tpu.data.scene import load_scene as j_load_scene
from riggs_tpu_torch.data import more_readers as TMR
from riggs_tpu_torch.data.colmap import qvec2rotmat as t_qvec2rotmat
from riggs_tpu_torch.data.scene import load_scene as t_load_scene


def _save_png(path, arr):
    Image.fromarray(arr).save(path)


def assert_scenes_equal(js, ts):
    """Every field of the port's scene against the reference's."""
    np.testing.assert_array_equal(ts.init_points, js.init_points)
    np.testing.assert_array_equal(ts.init_colors, js.init_colors)
    assert ts.cameras_extent == pytest.approx(js.cameras_extent, rel=1e-6)
    assert (ts.is_blender, ts.white_background, ts.train_image_names) == (
        js.is_blender, js.white_background, js.train_image_names)
    assert (len(ts.train_frames), len(ts.test_frames)) == (len(js.train_frames), len(js.test_frames))
    for jf, tf in zip(js.train_frames + js.test_frames, ts.train_frames + ts.test_frames):
        for name in ("image", "alpha_mask", "thinned", "thinned_mask", "semantic_seg", "reference_points"):
            a, b = getattr(jf, name), getattr(tf, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(b.cpu().numpy(), np.asarray(a), err_msg=name)
        for name in ("w2c", "intrinsics", "fid"):
            np.testing.assert_allclose(getattr(tf.cam, name).numpy(), np.asarray(getattr(jf.cam, name)),
                                       rtol=0, atol=1e-6, err_msg=name)
        assert (tf.cam.width, tf.cam.height) == (jf.cam.width, jf.cam.height)


def _both(path, **kw):
    js = j_load_scene(path, **kw)
    ts = t_load_scene(path, device="cpu", **kw)
    assert_scenes_equal(js, ts)
    return js, ts


# ---- COLMAP ----------------------------------------------------------------

COLMAP_CAMS = {1: ("PINHOLE", 1, 40, 32, [38.0, 36.5, 21.3, 14.2]),
               2: ("SIMPLE_RADIAL", 2, 40, 32, [41.0, 18.6, 17.1, 0.01])}


def _colmap_images(rng):
    out = []
    for i in range(4):
        q = rng.normal(size=4)
        q = q / np.linalg.norm(q)
        out.append((i + 1, q, rng.normal(scale=0.5, size=3) + [0, 0, 3.0], 1 + i % 2, f"frame_{3 - i:03d}.png"))
    return out


def _write_colmap(root, binary: bool, rng):
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    (root / "masks").mkdir()
    imgs = _colmap_images(rng)
    yy, xx = np.mgrid[:32, :40]
    for *_, name in imgs:
        _save_png(root / "images" / name, (rng.uniform(size=(32, 40, 3)) * 255).astype(np.uint8))
        blob = ((yy - 16) ** 2 / 90 + (xx - 20) ** 2 / 40 < 1) * rng.uniform(0.6, 1.0)
        _save_png(root / "masks" / name, (blob * 255).astype(np.uint8))
    pts = rng.normal(size=(30, 3))
    cols = rng.integers(0, 256, size=(30, 3))
    if binary:
        with open(sparse / "cameras.bin", "wb") as f:
            f.write(struct.pack("<Q", len(COLMAP_CAMS)))
            for cid, (_, model_id, w, h, params) in COLMAP_CAMS.items():
                f.write(struct.pack("<iiQQ", cid, model_id, w, h) + struct.pack(f"<{len(params)}d", *params))
        with open(sparse / "images.bin", "wb") as f:
            f.write(struct.pack("<Q", len(imgs)))
            for iid, q, t, cid, name in imgs:
                f.write(struct.pack("<idddddddi", iid, *q, *t, cid) + name.encode() + b"\x00")
                f.write(struct.pack("<Q", 2) + struct.pack("<ddq", 1.0, 2.0, 5) * 2)
        with open(sparse / "points3D.bin", "wb") as f:
            f.write(struct.pack("<Q", len(pts)))
            for i, (p, c) in enumerate(zip(pts, cols)):
                f.write(struct.pack("<QdddBBBd", i + 1, *p, *(int(v) for v in c), 0.5))
                f.write(struct.pack("<Q", 1) + struct.pack("<ii", 1, 0))
    else:
        (sparse / "cameras.txt").write_text("# cameras\n" + "".join(
            f"{cid} {model} {w} {h} {' '.join(map(str, params))}\n"
            for cid, (model, _, w, h, params) in COLMAP_CAMS.items()))
        floats = lambda a: " ".join(repr(float(v)) for v in a)
        (sparse / "images.txt").write_text("# images\n" + "".join(
            f"{iid} {floats(q)} {floats(t)} {cid} {name}\n1.0 2.0 5\n" for iid, q, t, cid, name in imgs))
        (sparse / "points3D.txt").write_text("# points\n" + "".join(
            f"{i + 1} {float(p[0])!r} {float(p[1])!r} {float(p[2])!r} {c[0]} {c[1]} {c[2]} 0.5 1 0\n"
            for i, (p, c) in enumerate(zip(pts, cols))))


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "text"])
def test_colmap_matches(tmp_path, binary):
    """The binary model with the masks and their thinned skeletons read,
    the text model without."""
    _write_colmap(tmp_path, binary, np.random.default_rng(1))
    js, ts = _both(tmp_path, llffhold=3, load_masks=binary)
    assert (ts.train_frames[0].thinned is not None) == binary
    assert len(ts.train_frames) == 2 and len(ts.test_frames) == 2 and len(ts.init_points) == 30
    assert float(ts.train_frames[0].cam.intrinsics[2]) == pytest.approx(21.3, abs=1e-5)  # off-centre
    q = np.random.default_rng(0).normal(size=4)
    np.testing.assert_array_equal(t_qvec2rotmat(q / np.linalg.norm(q)), j_qvec2rotmat(q / np.linalg.norm(q)))


def test_colmap_text_and_binary_agree(tmp_path):
    """The two model formats of one scene read to the same scene (the text
    floats written with repr, so exactly)."""
    a, b = tmp_path / "a", tmp_path / "b"
    _write_colmap(a, True, np.random.default_rng(2))
    _write_colmap(b, False, np.random.default_rng(2))
    sa, sb = t_load_scene(a, device="cpu"), t_load_scene(b, device="cpu")
    np.testing.assert_allclose(sa.init_points, sb.init_points, rtol=0, atol=0)
    for fa, fb in zip(sa.train_frames, sb.train_frames):
        np.testing.assert_array_equal(fa.cam.w2c.numpy(), fb.cam.w2c.numpy())


# ---- nerfies (tests/test_hash_viewer_nerfies.py's scene) --------------------

def test_nerfies_matches(tmp_path):
    ids = ["000001", "000002", "000003"]
    (tmp_path / "camera").mkdir()
    (tmp_path / "rgb" / "2x").mkdir(parents=True)
    json.dump({"ids": ids, "train_ids": ids[:2], "val_ids": ids[2:]}, open(tmp_path / "dataset.json", "w"))
    json.dump({i: {"time_id": k, "camera_id": 0} for k, i in enumerate(ids)}, open(tmp_path / "metadata.json", "w"))
    json.dump({"scale": 0.8, "center": [0.1, -0.2, 0.05]}, open(tmp_path / "scene.json", "w"))
    rng = np.random.default_rng(0)
    for k, i in enumerate(ids):
        json.dump({"orientation": np.eye(3).tolist(), "position": [0.1 * k, 0, -3.0], "focal_length": 400.0,
                   "principal_point": [64, 60] if k else [0, 0], "image_size": [128, 128]},
                  open(tmp_path / "camera" / f"{i}.json", "w"))
        _save_png(tmp_path / "rgb" / "2x" / f"{i}.png", (rng.uniform(size=(64, 64, 3)) * 255).astype(np.uint8))
    js, ts = _both(tmp_path, n_init_points=200)
    assert len(ts.train_frames) == 2 and len(ts.test_frames) == 1
    np.save(tmp_path / "points.npy", rng.normal(size=(40, 3)).astype(np.float32))
    _both(tmp_path, compute_thinned=True)


# ---- DTU, Plenoptic, CMU (tests/test_more_readers.py's scenes) --------------

@pytest.fixture
def dtu_dir(tmp_path):
    n = 3
    (tmp_path / "image").mkdir()
    (tmp_path / "mask").mkdir()
    cams = {}
    for i in range(n):
        img = (np.random.default_rng(i).random((32, 40, 3)) * 255).astype(np.uint8)
        _save_png(tmp_path / "image" / f"{i:06d}.png", img)
        _save_png(tmp_path / "mask" / f"{i:06d}.png", np.full((32, 40), 255, np.uint8))
        K = np.array([[40.0, 0, 20], [0, 40.0, 16], [0, 0, 1]])
        R = np.eye(3)
        t = np.array([0.1 * i, 0, 2.5])
        P = K @ np.concatenate([R, t[:, None]], axis=1)
        world = np.eye(4)
        world[:3, :4] = P
        cams[f"world_mat_{i}"] = world
        cams[f"scale_mat_{i}"] = np.eye(4)
        cams[f"fid_{i}"] = np.array(float(i))
    np.savez(tmp_path / "cameras_sphere.npz", **cams)
    return tmp_path


def test_dtu_matches(dtu_dir):
    _, ts = _both(dtu_dir, n_init_points=500)
    assert ts.train_image_names == ["000000", "000001", "000002"]


def test_projection_decomposition_matches():
    rng = np.random.default_rng(0)
    K = np.array([[50.0, 0, 24], [0, 48.0, 18], [0, 0, 1]])
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    P = K @ np.concatenate([Q, rng.normal(size=(3, 1))], axis=1)
    for a, b in zip(TMR.decompose_projection(P), JMR.decompose_projection(P)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TMR.load_K_Rt_from_P(P), JMR.load_K_Rt_from_P(P)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def plenoptic_dir(tmp_path):
    n_cams, n_frames = 3, 4
    poses = np.zeros((n_cams, 3, 5))
    for i in range(n_cams):
        c2w = np.eye(4)
        c2w[0, 3] = 0.2 * i
        c2w[2, 3] = 2.0
        m = np.concatenate([-c2w[:3, 1:2], c2w[:3, 0:1], c2w[:3, 2:4]], axis=1)
        poses[i, :, :4] = m
        poses[i, :, 4] = [24, 32, 30.0]  # H, W, focal
    bounds = np.ones((n_cams, 2))
    np.save(tmp_path / "poses_bounds.npy", np.concatenate([poses.reshape(n_cams, 15), bounds], axis=1))
    for i in range(n_cams):
        d = tmp_path / "frames" / f"cam{i:02d}"
        d.mkdir(parents=True)
        for f in range(n_frames):
            _save_png(d / f"{f:04d}.png", np.full((24, 32, 3), 40 * (f + 1), np.uint8))
    return tmp_path


@pytest.mark.parametrize("eval_split", [True, False])
def test_plenoptic_matches(plenoptic_dir, eval_split):
    _, ts = _both(plenoptic_dir, num_images=4, hold_id=(0,), eval_split=eval_split, n_init_points=300)
    assert len(ts.train_frames) == (8 if eval_split else 12)


@pytest.fixture
def cmu_dir(tmp_path):
    n_t, n_c = 2, 2
    (tmp_path / "ims").mkdir()
    (tmp_path / "seg").mkdir()
    fn, ks, w2cs = [], [], []
    for t in range(n_t):
        fn.append([f"{c}/{t:06d}.jpg" for c in range(n_c)])
        ks.append([[[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]] for _ in range(n_c)])
        row = []
        for c in range(n_c):
            w2c = np.eye(4)
            w2c[0, 3] = 0.1 * c
            w2c[2, 3] = 2.0
            row.append(w2c.tolist())
        w2cs.append(row)
    for t in range(n_t):
        for c in range(n_c):
            (tmp_path / "ims" / f"{c}").mkdir(exist_ok=True)
            _save_png(tmp_path / "ims" / f"{c}" / f"{t:06d}.jpg", np.full((24, 32, 3), 120, np.uint8))
            (tmp_path / "seg" / f"{c}").mkdir(exist_ok=True)
            _save_png(tmp_path / "seg" / f"{c}" / f"{t:06d}.png", np.full((24, 32), 255, np.uint8))
    meta = {"w": 32, "h": 24, "k": ks, "w2c": w2cs, "fn": fn}
    (tmp_path / "train_meta.json").write_text(json.dumps(meta))
    (tmp_path / "test_meta.json").write_text(json.dumps(dict(meta, fn=[row[:1] for row in fn])))
    pts = np.random.default_rng(0).random((50, 7)).astype(np.float32)
    np.savez(tmp_path / "init_pt_cld.npz", data=pts)
    return tmp_path


@pytest.mark.parametrize("norm", [True, False])
def test_cmu_matches(cmu_dir, norm):
    _, ts = _both(cmu_dir, apply_cam_norm=norm, recenter_by_pcl=norm)
    assert len(ts.train_frames) == 4 and len(ts.test_frames) == 2
