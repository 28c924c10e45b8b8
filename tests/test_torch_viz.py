"""The viewers of riggs_tpu_torch against riggs_tpu: viz/sibr.py (the
camera message, the image bytes, a round trip over a socket with either
package's client), viz/overlay.py, viz/web_viewer.py (render_frame in every
mode on the tiny scene at 64 x 64, the HTTP endpoints on an ephemeral port),
and the twins scripts/torch_viewer.py (served and stopped) and
scripts/torch_test_speed.py. tests/test_sibr.py and
tests/test_hash_viewer_nerfies.py::TestViewerHTTP are the templates.

Tolerances: the SIBR camera 1e-6 and its bytes exactly; overlays exactly;
frames 3e-5 (tests/test_pallas_blend.py's image bound); the edit endpoints
and the node-warp frame against the port's own session and render exactly
(the session and warp_forward are held to the reference elsewhere); a
served PNG exactly its frame quantized.
"""
import io
import json
import re
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from riggs_tpu.camera.camera import make_camera as j_make_camera
from riggs_tpu.viz import overlay as JOv
from riggs_tpu.viz import sibr as JSi
from riggs_tpu.viz import web_viewer as JV
from riggs_tpu_torch import convert
from riggs_tpu_torch.camera.camera import make_camera as t_make_camera
from riggs_tpu_torch.viz import overlay as TOv
from riggs_tpu_torch.viz import sibr as TSi
from riggs_tpu_torch.viz import web_viewer as TV
from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (autouse)

IMG_TOL = 3e-5


def _to_view_matrix(w2c):
    """The client's form of w2c: its transpose with the Y/Z columns negated."""
    m = np.asarray(w2c, np.float32).T.copy()
    m[:, 1:3] = -m[:, 1:3]
    return m


def _cams(w=64, h=48):
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    T = np.array([0.1, -0.2, 2.5])
    return (j_make_camera(q, T, w, h, fovx=0.9, fovy=0.8), t_make_camera(q, T, w, h, fovx=0.9, fovy=0.8, device="cpu"))


def test_camera_from_message_matches():
    jc, _ = _cams()
    msg = dict(resolution_x=64, resolution_y=48, fov_x=0.9, fov_y=0.8, z_near=0.02, z_far=50.0,
               view_matrix=_to_view_matrix(np.asarray(jc.w2c)).reshape(-1).tolist())
    a, b = JSi.camera_from_message(msg), TSi.camera_from_message(msg, device="cpu")
    np.testing.assert_allclose(b.w2c.numpy(), np.asarray(a.w2c), rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.w2c.numpy(), np.asarray(jc.w2c), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(b.intrinsics.numpy(), np.asarray(a.intrinsics))
    assert (b.width, b.height, b.znear, b.zfar) == (a.width, a.height, a.znear, a.zfar) == (64, 48, 0.02, 50.0)
    assert TSi.camera_from_message(dict(resolution_x=0, resolution_y=0)) is None


def test_encode_image_matches():
    rng = np.random.default_rng(1)
    img = rng.uniform(-0.2, 1.2, size=(16, 24, 3)).astype(np.float32)
    img[0, :4, 0] = [0.0, 1.0, 0.5, 127.5 / 255]
    want = JSi.encode_image(img)
    assert TSi.encode_image(img) == want
    assert TSi.encode_image(torch.tensor(img)) == want
    np.testing.assert_array_equal(TSi.quantize(torch.tensor(img)), np.frombuffer(want, np.uint8).reshape(16, 24, 3))


@pytest.mark.parametrize("client", ["reference", "port"])
def test_sibr_round_trip(client):
    """The port's server polled as a training loop polls it, with either
    package's client: the image bytes are encode_image of the rendered
    frame, the verify string arrives, and the render saw the client's camera
    and scaling modifier. A message that is not the protocol's drops the
    client; a failing render propagates."""
    served = {}

    def render_fn(cam, scaling_modifier):
        served.update(cam=cam, scale=scaling_modifier)
        return torch.linspace(0, 1, cam.height * cam.width * 3).reshape(cam.height, cam.width, 3)

    server = TSi.SibrServer("127.0.0.1", 0, verify="/data/scene", device="cpu")
    result = {}
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 2.5

    def client_side():
        c = (JSi if client == "reference" else TSi).SibrClient("127.0.0.1", server.port)
        result["img"], result["verify"] = c.request(32, 24, _to_view_matrix(w2c), train=True, scaling_modifier=0.7)
        c.close()

    t = threading.Thread(target=client_side)
    t.start()
    for _ in range(200):
        server.poll(render_fn)
        if result:
            break
        time.sleep(0.05)
    t.join(timeout=5)
    cam, scale = served["cam"], served["scale"]
    assert result["verify"] == "/data/scene"
    assert result["img"].tobytes() == TSi.encode_image(render_fn(cam, scale))
    assert scale == pytest.approx(0.7)
    np.testing.assert_allclose(cam.w2c.numpy(), w2c, atol=1e-6)

    bad = TSi.SibrClient("127.0.0.1", server.port)  # a length prefix with a body that is not JSON
    bad.sock.sendall((5).to_bytes(4, "little") + b"nope!")
    for _ in range(100):
        server.poll(render_fn)
        if _drained(bad):
            break
        time.sleep(0.02)
    assert server.conn is None
    bad.close()

    def broken(cam, scaling_modifier):
        raise RuntimeError("kernel failed")

    c = TSi.SibrClient("127.0.0.1", server.port)
    payload = json.dumps(dict(resolution_x=8, resolution_y=8, fov_x=0.9, fov_y=0.9,
                                  view_matrix=_to_view_matrix(w2c).reshape(-1).tolist())).encode()
    c.sock.sendall(len(payload).to_bytes(4, "little") + payload)
    with pytest.raises(RuntimeError, match="kernel failed"):
        for _ in range(100):
            server.poll(broken)
            time.sleep(0.02)
    c.close()
    server.close()


def _drained(client) -> bool:
    """Whether the server closed this client's connection."""
    client.sock.settimeout(0.01)
    try:
        return client.sock.recv(1) == b""
    except (BlockingIOError, TimeoutError, OSError):
        return False


def test_overlays_match():
    rng = np.random.default_rng(2)
    jc, tc = _cams(80, 60)
    img = rng.uniform(size=(60, 80, 3)).astype(np.float32)
    joints = rng.normal(scale=0.4, size=(6, 3)).astype(np.float32)
    parents = np.array([-1, 0, 1, 1, 3, 4])
    a = JOv.overlay_skeleton(img, jc, jnp.asarray(joints), parents)
    b = TOv.overlay_skeleton(torch.tensor(img), tc, joints, parents)
    np.testing.assert_array_equal(b, np.asarray(a))
    assert not np.array_equal(b, img)
    traj = rng.normal(scale=0.4, size=(3, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(TOv.overlay_trajectories(img, tc, traj),
                                  np.asarray(JOv.overlay_trajectories(img, jc, jnp.asarray(traj))))


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_render():
    """The reference viewer's render (riggs_tpu.render.api.render, which
    render_frame imports at each call) compiled as one graph: run eagerly,
    its first frame compiles every primitive on its own (~20 s here)."""
    from riggs_tpu.render import api as JR

    real = JR.render
    JR.render = jax.jit(real, static_argnames=("active_sh_degree", "max_per_tile", "render_motion"))
    yield
    JR.render = real


@pytest.fixture(scope="module")
def viewers(tmp_path_factory):
    """The tiny scene's model (256 slots, SH 1, a three-joint skeleton with
    both MLPs) in both packages, each in a 64 x 64 viewer with its own pose
    library."""
    import __graft_entry__ as g

    tmp = tmp_path_factory.mktemp("viewers")
    _, state = g._build_tiny_scene(width=48, height=48, n_train=1, render_gt=False)
    gs, skel = state.gs, state.skel
    np_ = lambda t: jax.tree.map(np.asarray, t)
    tgs = convert.gaussians_from_numpy(np_(gs.params_dict()), np.asarray(gs.alive), gs.max_sh_degree, gs.isotropic,
                                       gs.with_motion_mask, device="cpu")
    tsk = convert.skeleton_warp_from_numpy(np_(skel.params_dict()), np.asarray(skel.joints), (0, 0, 1), K=-1,
                                           device="cpu")
    jv = JV.ViewerServer(gs, skel=skel, width=64, height=64, pose_lib_path=tmp / "j.json")
    tv = TV.ViewerServer(tgs, skel=tsk, width=64, height=64, pose_lib_path=tmp / "t.json", device="cpu")
    return jv, tv, tmp


def _frame_pair(viewers, *args):
    jv, tv, _ = viewers
    return np.asarray(jv.render_frame(*args)), tv.render_frame(*args).numpy()


@pytest.mark.parametrize("mode", ["rgb", "skinning", "motion", "joint_edit"])
def test_render_frame_matches(viewers, mode):
    args = (0.4, 0.3, 3.0, 0.3) + (("rgb", 1, 30.0) if mode == "joint_edit" else (mode,))
    a, b = _frame_pair(viewers, *args)
    assert b.shape == (64, 64, 3) and float(np.abs(a).max()) > 0.05
    np.testing.assert_allclose(b, a, rtol=0, atol=IMG_TOL)


def test_pose_library_playback_and_retarget_match(viewers):
    """The same API calls on both viewers: saved poses (one with a joint
    edit, the files within 1e-6), a SLERP sequence's frame, a retargeted pose
    (a source skeleton of two joints, the nearest-joint branch)."""
    jv, tv, tmp = viewers
    for v in (jv, tv):
        assert v.handle_api("/pose/save", {"name": "rest", "t": "0"}) == {"saved": "rest"}
        assert v.handle_api("/pose/save", {"name": "bent", "t": "0.5", "joint": "1", "angle": "45"}) == {"saved": "bent"}
        assert v.handle_api("/pose/list", {}) == ["bent", "rest"]
        assert v.handle_api("/pose/play", {"names": "rest,bent", "frames": "4"}) == {"frames": 4}
    for name in ("rest", "bent"):
        for a, b in zip(jv.pose_lib.get(name), TV.PoseLibrary(tmp / "t.json").get(name)):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    a, b = _frame_pair(viewers, 0.0, 0.3, 3.0, 0.0, "rgb", -1, 0.0, 2)
    np.testing.assert_allclose(b, a, rtol=0, atol=IMG_TOL)
    src = tmp / "src"
    src.mkdir()
    np.savez(src / "skeleton_tree.npz", joints=np.asarray(jv.skel.joints)[:2])
    (src / "poses.json").write_text((tmp / "t.json").read_text())
    for v in (jv, tv):
        assert v.handle_api("/pose/clear", {}) == {"ok": True}
        assert v.handle_api("/retarget", {"path": str(src), "name": "bent"}) == {"joints_src": 2, "joints_dst": 3}
    a, b = _frame_pair(viewers, 0.0, 0.3, 3.0, 0.9)
    np.testing.assert_allclose(b, a, rtol=0, atol=IMG_TOL)
    for v in (jv, tv):
        v.handle_api("/pose/clear", {})


def test_edit_endpoints_drive_the_session(viewers):
    """/edit/init, a pick at a control point's pixel and a drag: the port's
    viewer holds the EditSession those calls make on its own (held to the
    reference's in tests/test_torch_edit.py), and its edited frame is the
    render of that session's d_xyz."""
    from riggs_tpu_torch.camera.camera import project_nodes_2d
    from riggs_tpu_torch.render.api import render

    _, tv, _ = viewers
    assert tv.handle_api("/edit/init", {"n": "16"}) == {"n_ctrl": 16}
    ref = TV.EditSession(tv.gs.xyz, n_ctrl=16, device="cpu")
    np.testing.assert_array_equal(tv.edit.ctrl_rest.numpy(), ref.ctrl_rest.numpy())
    cam = tv._camera(0.0, 0.3, 3.0)
    rc = project_nodes_2d(cam, ref.ctrl_rest).numpy()
    q = {"x": str(rc[2, 1]), "y": str(rc[2, 0]), "az": "0", "el": "0.3", "r": "3.0"}
    assert tv.handle_api("/edit/pick", q) == {"picked": 2, "n_keypoints": 1}
    assert ref.pick(cam, rc[2, 1], rc[2, 0]) == 2
    assert tv.handle_api("/edit/drag", {"dx": "6", "dy": "-3", "az": "0", "el": "0.3", "r": "3.0"}) == {"n_keypoints": 1}
    ref.drag(cam, 6.0, -3.0)
    np.testing.assert_array_equal(tv.edit.d_xyz.numpy(), ref.d_xyz.numpy())
    assert float(ref.d_xyz.abs().max()) > 1e-3
    want = render(cam, tv.gs, torch.zeros(3), d_xyz=ref.d_xyz, active_sh_degree=tv.gs.max_sh_degree, max_per_tile=512)
    np.testing.assert_array_equal(tv.render_frame(0.0, 0.3, 3.0, 0.0, "edited").numpy(), want["render"].numpy())
    assert tv.handle_api("/edit/clear", {}) == {"ok": True}
    assert float(tv.edit.d_xyz.abs().max()) == 0.0


def test_render_frame_of_a_node_warp():
    """A stage-1 model (64 Gaussians under a 16-node warp, no hyper
    coordinates): the frame at t = 0.4 is the render of node_warp's
    warp_forward (held to the reference in tests/test_torch_stage1_modules.py)
    with the reference viewer's arguments."""
    from riggs_tpu_torch.models import gaussians as TG
    from riggs_tpu_torch.models import node_warp as TNW
    from riggs_tpu_torch.render.api import render

    rng = np.random.default_rng(3)
    pcl = rng.normal(scale=0.3, size=(64, 3)).astype(np.float32)
    gs = TG.create_from_pcd(pcl, rng.uniform(size=(64, 3)).astype(np.float32), 64, max_sh_degree=0, device="cpu")
    warp = TNW.init_node_warp(pcl, 16, hyper_dim=0, generator=torch.Generator().manual_seed(1), device="cpu")
    v = TV.ViewerServer(gs, warp=warp, width=64, height=64, device="cpu")
    d = TNW.warp_forward(warp, gs.xyz, 0.4, gs.feature, gs.motion_mask)
    with torch.no_grad():
        want = render(v._camera(0.0, 0.3, 1.5), gs, torch.zeros(3), d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                      d_scaling=torch.zeros_like(d["d_scaling"]), active_sh_degree=0, max_per_tile=512)["render"]
    got = v.render_frame(0.0, 0.3, 1.5, 0.4)
    assert float(got.abs().max()) > 0.05
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _get(port, path):
    """(status, body) of a GET on localhost."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _png(body) -> np.ndarray:
    assert body[:4] == b"\x89PNG"
    return np.asarray(Image.open(io.BytesIO(body)))


def test_http_endpoints_on_an_ephemeral_port(viewers, tmp_path):
    """The port's viewer on port 0: the page, a /render PNG equal to its
    frame quantized, the pose and edit endpoints, and the error codes (404
    unknown, 400 malformed or out of order, 503 a live viewer with no model
    yet, 500 a failing render)."""
    _, tv, _ = viewers
    tv.serve(port=0, blocking=False)
    port = tv.httpd.server_address[1]
    try:
        status, html = _get(port, "/")
        assert status == 200 and b"canvas" in html
        status, body = _get(port, "/render?t=0.3&az=0.2&mode=rgb&joint=1&angle=20")
        assert status == 200
        np.testing.assert_array_equal(_png(body), TSi.quantize(tv.render_frame(0.2, 0.3, 3.0, 0.3, "rgb", 1, 20.0)))
        assert _get(port, "/render?mode=skinning")[0] == 200
        assert json.loads(_get(port, "/pose/save?name=a&t=0.1")[1]) == {"saved": "a"}
        assert json.loads(_get(port, "/pose/save?name=b&t=0.7")[1]) == {"saved": "b"}
        assert json.loads(_get(port, "/pose/play?names=a,b&frames=3")[1]) == {"frames": 3}
        assert _get(port, "/render?seq=2")[0] == 200
        assert _get(port, "/edit/clear")[0] == 200
        tv.edit = None
        assert _get(port, "/edit/pick?x=1&y=1")[0] == 400
        assert _get(port, "/pose/save")[0] == 400
        assert _get(port, "/render?t=abc")[0] == 400
        assert _get(port, "/nope")[0] == 404
        assert json.loads(_get(port, "/edit/init?n=8")[1]) == {"n_ctrl": 8}
        assert json.loads(_get(port, "/edit/pick?x=-900&y=-900")[1]) == {"picked": -1, "n_keypoints": 0}
        assert _get(port, "/render?mode=edited")[0] == 200
        assert _get(port, "/pose/clear")[0] == 200
    finally:
        tv.shutdown()
    live = {"state": (None, None, None)}
    lv = TV.ViewerServer(state_fn=lambda: live["state"], width=32, height=32, pose_lib_path=tmp_path / "p.json",
                         device="cpu")
    lv.serve(port=0, blocking=False)
    try:
        port = lv.httpd.server_address[1]
        assert _get(port, "/render")[0] == 503
        live["state"] = (tv.gs, None, None)
        assert _get(port, "/render")[0] == 200
        live["state"] = (tv.gs, None, "not a warp")
        status, body = _get(port, "/render")
        assert status == 500 and b"error" in body
    finally:
        lv.shutdown()


def test_viewer_needs_a_device_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TV.ViewerServer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSi.SibrServer("127.0.0.1", 0)


@pytest.fixture(scope="module")
def rig_dir(tmp_path_factory):
    """A rig directory as the pipeline writes it, from the port's tiny scene
    (scripts/torch_scaling_bench.py) with its skeleton's nets moved off
    init: cfg.json, skeleton_tree.npz, rig/point_cloud/ and rig/checkpoints/."""
    from riggs_tpu_torch.io.checkpoint import save_checkpoint, save_skeleton_tree
    from riggs_tpu_torch.train.config import Config
    from scripts.torch_scaling_bench import build_tiny_scene

    mp = tmp_path_factory.mktemp("rig")
    _, state = build_tiny_scene(48, 48, n_train=3, render_gt=False, device="cpu")
    with torch.no_grad():
        gen = torch.Generator().manual_seed(0)
        for p in state.skel.pose_mlp.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    cfg = Config()
    cfg.model.capacity, cfg.model.sh_degree = state.gs.capacity, state.gs.max_sh_degree
    cfg.model.use_skinning_weight_mlp = cfg.model.use_template_offsets = True
    cfg.opt.skeleton_weight_knn = -1
    cfg.save(mp / "cfg.json")
    joints = state.skel.joints.numpy()
    save_skeleton_tree(mp, joints, np.array([-1, 0, 1]), np.arange(3), 0)
    save_checkpoint(mp / "rig", 7, state, gs=state.gs, cfg=cfg)
    return mp, state


def test_viewer_twin_serves_the_rig_and_stops(rig_dir, monkeypatch):
    """scripts/torch_viewer.py on port 0 in a thread: it loads the rig's
    checkpoint (the moved pose net), serves the frame a viewer of the saved
    state renders, and returns once stopped."""
    from scripts import torch_viewer

    mp, state = rig_dir
    made = []
    real = torch_viewer.load_viewer

    def load_small(*a):
        made.append(real(*a))
        made[-1].width = made[-1].height = 64  # the frames of this test: 64 x 64, not the default 512
        return made[-1]

    monkeypatch.setattr(torch_viewer, "load_viewer", load_small)
    t = threading.Thread(target=torch_viewer.main, args=(["--model_path", str(mp), "--port", "0", "--device", "cpu"],))
    t.start()
    for _ in range(600):
        if made and made[0].httpd is not None:
            break
        time.sleep(0.05)
    v = made[0]
    try:
        status, body = _get(v.httpd.server_address[1], "/render?t=0.6")
        assert status == 200
        want = TV.ViewerServer(state.gs, skel=state.skel, width=64, height=64, device="cpu").render_frame(
            0.0, 0.3, 3.0, 0.6)
        np.testing.assert_array_equal(_png(body), TSi.quantize(want))
    finally:
        v.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()


@pytest.mark.parametrize("source", ["synthetic", "rig_ladder"])
def test_fps_twin_prints_the_reference_line(source, rig_dir, capsys):
    from scripts import torch_test_speed

    args = ["--renders", "2", "--size", "48", "--device", "cpu"]
    args += ["--synthetic"] if source == "synthetic" else ["--model_path", str(rig_dir[0]), "--ladder"]
    torch_test_speed.main(args)
    out = capsys.readouterr().out
    assert re.search(r"^2 renders at 48x48: [0-9.]+s = [0-9.]+ FPS \([0-9.]+ Mpix/s\)$", out, re.M), out
    assert ("ladder: (" in out) == (source != "synthetic")
    assert "first frame: overflow_tiles 0, overflow_rect 0" in out


PILE = 700  # splats piled at the origin: more than the viewer's window of 512 in each tile they touch


def _piled_params(n_pile=PILE, n_spread=100, seed=5):
    """SH-0 Gaussians: ``n_pile`` faint splats piled at the origin, where
    a viewer at any orbit looks, and ``n_spread`` spread over the frame;
    opacity 0.005, so that the pile stays far from saturating and a
    truncated window changes the frame."""
    rng = np.random.default_rng(seed)
    n = n_pile + n_spread
    xyz = np.concatenate([rng.normal(scale=0.03, size=(n_pile, 3)), rng.normal(scale=0.5, size=(n_spread, 3))])
    return {"xyz": xyz.astype(np.float32), "f_dc": rng.normal(scale=0.5, size=(n, 1, 3)).astype(np.float32),
            "f_rest": np.zeros((n, 0, 3), np.float32), "scaling": np.full((n, 3), np.log(0.1), np.float32),
            "rotation": np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
            "opacity": np.full((n, 1), np.log(0.005 / 0.995), np.float32), "feature": np.zeros((n, 0), np.float32)}


@pytest.fixture(scope="module")
def piled(tmp_path_factory):
    """The piled model in both packages, each in a 64 x 64 viewer."""
    from riggs_tpu.models.gaussians import Gaussians as JGaussians

    tmp = tmp_path_factory.mktemp("piled")
    p = _piled_params()
    alive = np.ones(len(p["xyz"]), bool)
    jgs = JGaussians(xyz=jnp.asarray(p["xyz"]), features_dc=jnp.asarray(p["f_dc"]),
                     features_rest=jnp.asarray(p["f_rest"]), scaling=jnp.asarray(p["scaling"]),
                     rotation=jnp.asarray(p["rotation"]), opacity=jnp.asarray(p["opacity"]),
                     feature=jnp.asarray(p["feature"]), alive=jnp.asarray(alive), max_sh_degree=0, isotropic=False,
                     with_motion_mask=False)
    tgs = convert.gaussians_from_numpy(p, alive, 0, with_motion_mask=False, device="cpu")
    jv = JV.ViewerServer(jgs, width=64, height=64, pose_lib_path=tmp / "j.json")
    tv = TV.ViewerServer(tgs, width=64, height=64, pose_lib_path=tmp / "t.json", device="cpu")
    return jv, tv, p


def _direct(tv, view, **kw):
    """The port's render of the viewer's static model at ``view``."""
    from riggs_tpu_torch.render.api import render

    with torch.no_grad():
        return render(tv._camera(*view), tv.gs, torch.zeros(3), active_sh_degree=0, **kw)


def test_render_frame_holds_an_overflowing_frame(piled):
    """C8: the reference viewer's window of 512 truncates the piled frame;
    the port's frame is the render at a window that holds it (2e-5), its
    counters 0 in the /render reply's headers too, on the tile ladder the
    viewer keeps; a later frame on that ladder holds as well."""
    from riggs_tpu.render import api as JR

    jv, tv, _ = piled
    view = (0.0, 0.3, 3.0)
    ref = JR.render(jv._camera(*view), jv.gs, jnp.zeros(3), active_sh_degree=0, max_per_tile=512)
    assert int(ref["overflow_tiles"]) > 0 and int(ref["max_count"]) > 512
    held = _direct(tv, view, max_per_tile=1024)
    assert int(held["overflow"]) == 0
    truncated = np.asarray(jv.render_frame(*view, 0.0))
    assert float(np.abs(truncated - held["render"].numpy()).max()) > 1e-2  # truncation shows in the frame
    tv.frames.ladder = None
    frame = tv.render_frame(*view, 0.0)
    assert tv.frames.overflow == {"overflow_tiles": 0, "overflow_rect": 0} and tv.frames.ladder is not None
    np.testing.assert_allclose(frame.numpy(), held["render"].numpy(), rtol=0, atol=2e-5)
    fitted = tv.frames.ladder.ladder
    tv.serve(port=0, blocking=False)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{tv.httpd.server_address[1]}/render?az=0.5", timeout=60) as r:
            body, headers = r.read(), r.headers
    finally:
        tv.shutdown()
    assert (headers["X-Overflow-Tiles"], headers["X-Overflow-Rect"]) == ("0", "0") and tv.frames.ladder.ladder == fitted
    np.testing.assert_array_equal(_png(body), TSi.quantize(_direct(tv, (0.5, 0.3, 3.0), max_per_tile=1024)["render"]))


@pytest.mark.parametrize("window", [256, 1024])
def test_frame_holder_at_the_sibr_window(piled, window):
    """The pipeline twin's SIBR endpoint renders through a FrameHolder at
    its training window: at 256 the piled frame overflows and is held on a
    ladder (2e-5 of a window that holds it); at 1024, which holds it, it is
    bitwise the single render at 1024. The counters are 0 both ways."""
    _, tv, _ = piled
    view = (0.0, 0.3, 3.0)
    want = _direct(tv, view, max_per_tile=1024)["render"]
    frames = TV.FrameHolder(window)
    with torch.no_grad():
        got = frames(tv._camera(*view), tv.gs, torch.zeros(3), active_sh_degree=0)
    assert frames.overflow == {"overflow_tiles": 0, "overflow_rect": 0}
    assert (frames.ladder is None) == (window == 1024)
    if window == 1024:
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


def test_render_frame_keeps_the_reference_frame_where_512_holds(viewers, piled):
    """Where the window of 512 holds, the frame is bitwise the single render
    at 512 (test_render_frame_matches holds it to the reference viewer's):
    on the tiny scene, and on a model that fits after one that did not,
    which drops the ladder."""
    from riggs_tpu_torch.models import skeleton_warp as TSW
    from riggs_tpu_torch.render.api import render

    _, tv, _ = viewers
    got = tv.render_frame(0.4, 0.3, 3.0, 0.3)
    d = TSW.pose_at(tv.skel, 0.3)
    d = TSW.deform_by_pose(tv.skel, tv.gs.xyz, d["local_rotation"], d["global_trans"], tv.gs.motion_mask)
    with torch.no_grad():
        want = render(tv._camera(0.4, 0.3, 3.0), tv.gs, torch.zeros(3), d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                      d_scaling=torch.zeros_like(d["d_scaling"]), active_sh_degree=tv.gs.max_sh_degree,
                      max_per_tile=512)["render"]
    assert tv.frames.ladder is None and tv.frames.overflow == {"overflow_tiles": 0, "overflow_rect": 0}
    np.testing.assert_array_equal(got.numpy(), want.numpy())

    _, pv, p = piled
    view = (0.0, 0.3, 3.0)
    pv.render_frame(*view, 0.0)
    assert pv.frames.ladder is not None
    alive = np.arange(len(p["xyz"])) >= PILE  # the spread splats alone
    thin = convert.gaussians_from_numpy(p, alive, 0, with_motion_mask=False, device="cpu")
    saved = pv._static
    pv._static = (thin, None, None)
    try:
        got = pv.render_frame(*view, 0.0)
    finally:
        pv._static = saved
    assert pv.frames.ladder is None and pv.frames.overflow == {"overflow_tiles": 0, "overflow_rect": 0}
    with torch.no_grad():
        want = render(pv._camera(*view), thin, torch.zeros(3), active_sh_degree=0, max_per_tile=512)["render"]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_render_frame_past_the_ceiling_warns_and_says_so(piled, monkeypatch):
    """A frame that no window up to window_ceiling holds is served
    truncated, with a warning and its counters."""
    _, tv, _ = piled
    monkeypatch.setattr(TV, "window_ceiling", lambda device, n_tiles: 256)
    monkeypatch.setattr(tv.frames, "ladder", None)
    with pytest.warns(UserWarning, match="capacity limits"):
        tv.render_frame(0.0, 0.3, 3.0, 0.0)
    assert tv.frames.overflow["overflow_tiles"] > 0


@pytest.mark.parametrize("ladder", [False, True], ids=["plain", "ladder"])
def test_fps_twin_holds_an_overflowing_rig(ladder, rig_dir, monkeypatch, capsys):
    """C8: a rig whose window of 1024 overflows (1200 splats piled at the
    origin): the plain window grows to the timed poses' largest tile
    before the timed loop, and the timed frames' overflow reads 0, plain
    and on the ladder."""
    from scripts import torch_test_speed

    skel = rig_dir[1].skel
    p = _piled_params(n_pile=1200, n_spread=50)
    gs = convert.gaussians_from_numpy(p, np.ones(1250, bool), 0, with_motion_mask=False, device="cpu")
    monkeypatch.setattr(torch_test_speed, "load_model", lambda model_path, device: (gs, skel))
    torch_test_speed.main(["--model_path", "piled", "--renders", "2", "--size", "48", "--device", "cpu"]
                          + (["--ladder"] if ladder else []))
    out = capsys.readouterr().out
    assert re.search(r"^2 renders at 48x48: [0-9.]+s = [0-9.]+ FPS", out, re.M), out
    assert "timed frames: overflow 0\n" in out
    if ladder:
        assert "ladder: (" in out and "plain window" not in out
    else:
        assert re.search(r"^first frame: overflow_tiles [1-9]", out, re.M), out
        assert "plain window 2048 (the timed poses' largest tile 12" in out and "overflow_tiles 0, overflow_rect 0\n" in out
