"""The port's IO against riggs_tpu's, on the same numpy inputs: the
skeleton OBJ, the coloured point-cloud PLY and the Gaussians' binary PLY
byte for byte; the whole-state .npz checkpoints of Stage1State and
Stage2State in both directions (a file the reference writes loads into the
port, one the port writes loads into the reference's load_state_npz with the
reference's own template), bit for bit on every leaf with the same key set,
dtypes and shapes; the errors for a missing or mis-shaped leaf; the search
for the latest iteration; the D-NeRF reader on a scene written into
tmp_path; and the scene dispatch, the same reader for each of the seven
layouts.

The states: the reference's init_stage1 and init_stage2 on
tests/test_torch_stage2_loop.py's scene and config, every leaf then replaced
by seeded values of its dtype (floats N(0, 1), alive masks with ~30% dead
rows, counts and iterations random ints), carried to the port through
riggs_tpu_torch.convert.
"""
import json

import jax
import numpy as np
import pytest
from PIL import Image

from riggs_tpu.data import blender as JB
from riggs_tpu.io import checkpoint as JC
from riggs_tpu.io import obj as JO
from riggs_tpu.io import ply as JP
from riggs_tpu.models.gaussians import Gaussians as JGaussians
from riggs_tpu.train import stage2 as JS2
from riggs_tpu_torch import convert
from riggs_tpu_torch.data import blender as TB
from riggs_tpu_torch.data import scene as TScene
from riggs_tpu_torch.io import checkpoint as TC
from riggs_tpu_torch.io import obj as TO
from riggs_tpu_torch.io import ply as TP

from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_stage1_step import _port_state as port_stage1
from tests.test_torch_stage2_init import stage1_fixture
from tests.test_torch_stage2_loop import JaxDraws, loop_cfg
from tests.test_torch_stage2_step import _np


def test_skeleton_obj_and_colored_ply_bytes_match(tmp_path):
    rng = np.random.default_rng(0)
    joints = rng.normal(size=(7, 3)).astype(np.float32)
    parents = [0, 0, 1, 1, 3, -1, 4]
    JO.write_skeleton_obj(tmp_path / "j" / "s.obj", joints, parents)
    TO.write_skeleton_obj(tmp_path / "t" / "s.obj", joints, parents)
    assert (tmp_path / "j" / "s.obj").read_bytes() == (tmp_path / "t" / "s.obj").read_bytes()
    jj, je = JO.read_skeleton_obj(tmp_path / "j" / "s.obj")
    tj, te = TO.read_skeleton_obj(tmp_path / "j" / "s.obj")
    np.testing.assert_array_equal(tj, jj)
    assert te == je and len(te) == 5
    values = rng.uniform(-0.2, 1.2, size=50)
    np.testing.assert_array_equal(TO.jet_colormap(values), JO.jet_colormap(values))
    pts, cols = rng.normal(size=(50, 3)).astype(np.float32), TO.jet_colormap(values)
    JO.write_colored_pointcloud_ply(tmp_path / "j" / "c.ply", pts, cols)
    TO.write_colored_pointcloud_ply(tmp_path / "t" / "c.ply", pts, cols)
    assert (tmp_path / "j" / "c.ply").read_bytes() == (tmp_path / "t" / "c.ply").read_bytes()


def _gaussian_arrays(rng, capacity, rest, scale_dim, fea):
    return dict(
        xyz=rng.normal(size=(capacity, 3)), f_dc=rng.normal(size=(capacity, 1, 3)),
        f_rest=rng.normal(size=(capacity, rest, 3)), scaling=rng.normal(size=(capacity, scale_dim)),
        rotation=rng.normal(size=(capacity, 4)), opacity=rng.normal(size=(capacity, 1)),
        feature=rng.normal(size=(capacity, fea)),
    )


@pytest.mark.parametrize("rest, scale_dim, fea", [(15, 3, 9), (0, 1, 0)])
def test_gaussians_ply_bytes_match_and_load_both_ways(tmp_path, rest, scale_dim, fea):
    rng = np.random.default_rng(rest)
    cap = 64
    params = {k: v.astype(np.float32) for k, v in _gaussian_arrays(rng, cap, rest, scale_dim, fea).items()}
    alive = rng.random(cap) > 0.3
    sh = {15: 3, 0: 0}[rest]
    iso = scale_dim == 1
    jgs = JGaussians(xyz=params["xyz"], features_dc=params["f_dc"], features_rest=params["f_rest"],
                     scaling=params["scaling"], rotation=params["rotation"], opacity=params["opacity"],
                     feature=params["feature"], alive=alive, max_sh_degree=sh, isotropic=iso,
                     with_motion_mask=fea > 0)
    tgs = convert.gaussians_from_numpy(params, alive, sh, isotropic=iso, with_motion_mask=fea > 0, device="cpu")
    JP.save_gaussians_ply(tmp_path / "j.ply", jgs)
    TP.save_gaussians_ply(tmp_path / "t.ply", tgs)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    kw = dict(capacity=128, max_sh_degree=sh, isotropic=iso, with_motion_mask=True)
    tl = TP.load_gaussians_ply(tmp_path / "j.ply", device="cpu", **kw)
    n = int(alive.sum())
    names = dict(xyz="xyz", features_dc="f_dc", features_rest="f_rest", scaling="scaling", opacity="opacity",
                 feature="feature")
    for f, k in names.items():
        want = np.zeros((128,) + params[k].shape[1:], np.float32)
        want[:n] = params[k][alive]
        np.testing.assert_array_equal(getattr(tl, f).numpy(), want, err_msg=f)
    np.testing.assert_array_equal(tl.rotation.numpy()[:n], params["rotation"][alive])
    np.testing.assert_array_equal(tl.rotation.numpy()[n:], np.tile([1, 0, 0, 0], (128 - n, 1)))
    np.testing.assert_array_equal(tl.alive.numpy(), np.arange(128) < n)
    assert tl.with_motion_mask == (fea > 0) and tl.capacity == 128
    if rest == 0:  # the reference's reader cannot stack an empty SH rest (ROADMAP Queue C)
        with pytest.raises(ValueError):
            JP.load_gaussians_ply(tmp_path / "t.ply", **kw)
        return
    jl = JP.load_gaussians_ply(tmp_path / "t.ply", **kw)
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "feature", "alive"):
        a, b = np.asarray(getattr(jl, f)), getattr(tl, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert jl.with_motion_mask == tl.with_motion_mask
    # the default capacity: the next power of two
    assert TP.load_gaussians_ply(tmp_path / "j.ply", device="cpu").capacity == JP.load_gaussians_ply(
        tmp_path / "j.ply").capacity == 64


def _perturbed(tree, seed):
    """Every leaf replaced by seeded values of its dtype and shape."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return rng.random(a.shape) > 0.3
        if a.dtype == np.int32:
            return rng.integers(1, 1000, size=a.shape).astype(np.int32)
        return rng.normal(size=a.shape).astype(a.dtype)

    return jax.tree.map(leaf, tree)


def _port_stage2(js):
    skel = js.skel
    adam = lambda o: (_np(o.mu), _np(o.nu), int(o.count))
    return convert.stage2_state_from_numpy(
        _np(js.gs.params_dict()), np.asarray(js.gs.alive), js.gs.max_sh_degree, _np(skel.params_dict()),
        np.asarray(skel.joints), skel.net.parents, adam(js.opt_gs), adam(js.opt_skel),
        tuple(np.asarray(a) for a in (js.stats_gs.xyz_gradient_accum, js.stats_gs.denom, js.stats_gs.max_radii2d)),
        np.asarray(js.proj_loss), it=int(js.it), isotropic=js.gs.isotropic, with_motion_mask=js.gs.with_motion_mask,
        K=skel.net.K, use_skinning_mlp=skel.net.use_skinning_mlp, use_template_offsets=skel.net.use_template_offsets,
        control_nodes=np.asarray(skel.control_nodes), device="cpu")


@pytest.fixture(scope="module")
def states():
    """(reference state, the same converted, a second port state of the
    same shapes with other values) for each stage."""
    js, jcfg, j1 = stage1_fixture(loop_cfg, n_test=1)
    j2, _, _ = JS2.init_stage2(JaxDraws(5).init_key, j1, js, jcfg)
    out = {}
    for name, ref, conv in (("stage1", j1, lambda js: port_stage1(js, it=int(js.it))), ("stage2", j2, _port_stage2)):
        ref = _perturbed(ref, 1)
        out[name] = (ref, conv(ref), conv(_perturbed(ref, 2)))
    return out


def _assert_same_leaves(got: dict, want: dict, what):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:5])
    for k, a in want.items():
        b = got[k]
        assert b.dtype == a.dtype and b.shape == a.shape, (what, k, b.dtype, a.dtype, b.shape, a.shape)
        np.testing.assert_array_equal(b, a, err_msg=f"{what} {k}")


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_state_leaves_are_the_reference_keys(states, stage):
    ref, port, _ = states[stage]
    leaves = TC.state_to_numpy(port)
    _assert_same_leaves(leaves, JC._flatten(ref), f"{stage} in memory")
    assert leaves[".it"].dtype == np.int32 and leaves[".gs.alive"].dtype == np.bool_
    assert any(a.size == 0 for a in leaves.values()) == (stage == "stage1")  # the node cloud's empty SH rest


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_checkpoint_written_by_the_reference_loads_into_the_port(states, tmp_path, stage):
    ref, _, other = states[stage]
    JC.save_checkpoint(tmp_path, 7, ref)
    loaded, it = TC.load_checkpoint(tmp_path, other)
    assert it == 7
    _assert_same_leaves(TC.state_to_numpy(loaded), JC._flatten(ref), f"{stage} reference -> port")
    # the template is left as it was; the copy shares no storage with it
    assert not np.array_equal(TC.state_to_numpy(other)[".gs.xyz"], np.asarray(ref.gs.xyz))
    assert loaded.gs.xyz.data_ptr() != other.gs.xyz.data_ptr()


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_checkpoint_written_by_the_port_loads_into_the_reference(states, tmp_path, stage):
    ref, port, _ = states[stage]
    TC.save_checkpoint(tmp_path, 9, port)
    with np.load(tmp_path / "checkpoints" / "iteration_9" / "state.npz") as data:
        _assert_same_leaves({k: data[k] for k in data.files}, JC._flatten(ref), f"{stage} port file")
    template = _perturbed(ref, 3)
    loaded, it = JC.load_checkpoint(tmp_path, template)
    assert it == 9
    _assert_same_leaves(JC._flatten(loaded), JC._flatten(ref), f"{stage} port -> reference")


def test_missing_or_misshaped_leaf_raises(states, tmp_path):
    _, port, other = states["stage2"]
    leaves = TC.state_to_numpy(port)
    np.savez(tmp_path / "missing.npz", **{k: v for k, v in leaves.items() if k != ".opt_skel.count"})
    with pytest.raises(KeyError, match=r"\.opt_skel\.count"):
        TC.load_state_npz(tmp_path / "missing.npz", other)
    key = ".skel.pose_mlp['layers'][0]['w']"
    bad = dict(leaves, **{key: leaves[key].T.copy()})
    np.savez(tmp_path / "shape.npz", **bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        TC.load_state_npz(tmp_path / "shape.npz", other)
    # the sharded pair reads the same leaves: a round trip onto the other state, then the same two faults
    TC.save_checkpoint_sharded(tmp_path, 0, port)
    back, it = TC.load_checkpoint_sharded(tmp_path, other)
    assert it == 0
    _assert_same_leaves(TC.state_to_numpy(back), leaves, "the sharded pair")
    rep = tmp_path / "sharded" / "iteration_0" / "replicated.npz"
    np.savez(rep, **{k: v for k, v in leaves.items() if k != ".opt_skel.count"})
    with pytest.raises(KeyError, match=r"\.opt_skel\.count"):
        TC.load_checkpoint_sharded(tmp_path, other)
    np.savez(rep, **bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        TC.load_checkpoint_sharded(tmp_path, other)


def test_search_max_iteration_and_latest_checkpoint(states, tmp_path):
    ref, port, other = states["stage1"]
    assert TC.search_max_iteration(tmp_path / "checkpoints") is None
    with pytest.raises(FileNotFoundError):
        TC.load_checkpoint(tmp_path, other)
    TC.save_checkpoint(tmp_path, 5, other)
    TC.save_checkpoint(tmp_path, 12, port, gs=port.gs)
    TC.save_checkpoint(tmp_path, 40, other)
    (tmp_path / "checkpoints" / "iteration_x").mkdir()
    (tmp_path / "checkpoints" / "iteration_40" / "state.npz").rename(tmp_path / "checkpoints" / "iteration_40.npz")
    (tmp_path / "checkpoints" / "iteration_40").rmdir()
    for folder in ("checkpoints", "point_cloud"):
        assert TC.search_max_iteration(tmp_path / folder) == JC.search_max_iteration(tmp_path / folder) == 12
    loaded, it = TC.load_checkpoint(tmp_path, other, iteration=-1)
    assert it == 12
    _assert_same_leaves(TC.state_to_numpy(loaded), JC._flatten(ref), "latest")
    assert TC.load_checkpoint(tmp_path, port, iteration=5)[1] == 5
    # the skeleton tree
    joints, parents, idx = np.ones((4, 3), np.float32), np.array([0, 0, 1, 1]), np.array([3, 1, 2, 0])
    TC.save_skeleton_tree(tmp_path / "t", joints, parents, idx, 2)
    JC.save_skeleton_tree(tmp_path / "j", joints, parents, idx, 2)
    for a, b in zip(TC.load_skeleton_tree(tmp_path / "j"), JC.load_skeleton_tree(tmp_path / "t")):
        np.testing.assert_array_equal(a, b)


def write_blender_scene(root, n_train=3, n_test=2, size=32):
    """A D-NeRF layout: RGBA frames with random alpha, train and test
    transforms with times, one precomputed thinned skeleton, one semantic
    segmentation."""
    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("test", n_test)):
        (root / split).mkdir(parents=True)
        frames = []
        for i in range(n):
            c2w = np.eye(4)
            c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            c2w[:3, 3] = rng.normal(size=3) + [0, 0, 3]
            img = (rng.uniform(size=(size, size, 4)) * 255).astype(np.uint8)
            img[..., 3] = 255 * (rng.uniform(size=(size, size)) > 0.4)
            Image.fromarray(img, "RGBA").save(root / split / f"r_{i}.png")
            frames.append({"file_path": f"./{split}/r_{i}", "time": (i + 0.5) / n, "transform_matrix": c2w.tolist()})
        rng.shuffle(frames)  # the reader sorts by the number in the name
        (root / f"transforms_{split}.json").write_text(json.dumps({"camera_angle_x": 0.7, "frames": frames}))
    (root / "train_thinned").mkdir()
    thin = np.zeros((size, size), np.uint8)
    thin[5:20, 7] = 255
    Image.fromarray(thin, "L").save(root / "train_thinned" / "r_1_thinned.png")
    (root / "semantic_seg").mkdir()
    np.save(root / "semantic_seg" / "r_0_seg.npy", rng.integers(0, 4, size=(1, size, size)))


@pytest.mark.parametrize("resolution, white", [(1, False), (2, True)])
def test_blender_reader_matches(tmp_path, resolution, white):
    write_blender_scene(tmp_path)
    js = JB.load_blender_scene(tmp_path, white_background=white, resolution=resolution, n_init_points=200,
                               max_thinned=64)
    ts = TScene.load_scene(tmp_path, white_background=white, resolution=resolution, n_init_points=200,
                           max_thinned=64, device="cpu")
    assert len(ts.train_frames) == len(js.train_frames) == 3 and len(ts.test_frames) == len(js.test_frames) == 2
    np.testing.assert_array_equal(ts.init_points, js.init_points)
    np.testing.assert_array_equal(ts.init_colors, js.init_colors)
    assert ts.cameras_extent == pytest.approx(js.cameras_extent, rel=1e-6)
    assert ts.train_image_names == js.train_image_names == ["r_0", "r_1", "r_2"]
    assert ts.white_background == white and ts.is_blender
    for tf, jf in zip(ts.train_frames + ts.test_frames, js.train_frames + js.test_frames):
        for name in ("image", "alpha_mask", "thinned", "thinned_mask", "semantic_seg"):
            a, b = getattr(jf, name), getattr(tf, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        for name in ("w2c", "intrinsics", "fid"):
            np.testing.assert_allclose(getattr(tf.cam, name).numpy(), np.asarray(getattr(jf.cam, name)),
                                       rtol=0, atol=1e-6, err_msg=name)
        assert (tf.cam.width, tf.cam.height) == (jf.cam.width, jf.cam.height)
    assert ts.train_frames[0].semantic_seg is not None and ts.train_frames[1].semantic_seg is None
    R, T = TB._nerf_c2w_to_rt(np.eye(4) + 0.1)
    jR, jT = JB._nerf_c2w_to_rt(np.eye(4) + 0.1)
    np.testing.assert_array_equal(R, jR)
    np.testing.assert_array_equal(T, jT)


LAYOUTS = (("train/cameras.pkl", "zju", "load_zju_scene"), ("dataset.json", "nerfies", "load_nerfies_scene"),
           ("sparse", "colmap", "load_colmap_scene"), ("colmap_sparse", "colmap", "load_colmap_scene"),
           ("cameras_sphere.npz", "more_readers", "load_dtu_scene"),
           ("poses_bounds.npy", "more_readers", "load_plenoptic_scene"),
           ("train_meta.json", "more_readers", "load_cmu_scene"))


def test_scene_dispatch_raises_for_readers_not_ported(tmp_path):
    """Every layout that riggs_tpu's load_scene recognises reaches the
    port's reader of the same name, with the same arguments (the readers
    stubbed here; tests/test_torch_readers.py and test_torch_zju.py hold
    them to the reference's); a directory of no layout still raises."""
    import importlib
    from unittest import mock

    for i, (marker, module, reader) in enumerate(LAYOUTS):
        root = tmp_path / str(i)
        (root / marker).parent.mkdir(parents=True, exist_ok=True)
        (root / marker).mkdir() if "." not in marker else (root / marker).write_text("")
        calls = {}
        for pkg in ("riggs_tpu", "riggs_tpu_torch"):
            mod = importlib.import_module(f"{pkg}.data.{module}")
            load = importlib.import_module(f"{pkg}.data.scene").load_scene
            with mock.patch.object(mod, reader, lambda *a, **k: (a, k)):
                a, k = load(root, white_background=True, resolution=2, marker=marker)
            calls[pkg] = (a, k)
        assert calls["riggs_tpu"] == calls["riggs_tpu_torch"], marker
    with pytest.raises(FileNotFoundError):
        TScene.load_scene(tmp_path / "nothing", device="cpu")
