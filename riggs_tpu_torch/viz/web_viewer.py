"""Interactive web viewer and editor over HTTP.

Port of ``riggs_tpu/viz/web_viewer.py``, with the same page, endpoints,
query parameters and JSON replies: a canvas page with mouse orbit and zoom,
a time slider, render modes (rgb, skinning weights, motion mask, the edited
cloud), joint pose editing about the view axis, drag-keypoint ARAP editing
(``edit/session.py``), a pose library with SLERP playback, and
reference-skeleton retargeting.

Endpoints beyond ``/`` and ``/render``:
    /pose/save?name=X         capture the current pose (incl. a joint edit) to the library
    /pose/list                saved pose names
    /pose/play?names=a,b&frames=20   build a SLERP playback sequence -> {"frames": F}
        then  /render?...&seq=i      renders frame i of the sequence
    /retarget?path=DIR&name=X load DIR/skeleton_tree.npz + DIR/poses.json and
                              retarget pose X onto this skeleton (the pose override)
    /pose/clear               drop the pose override and the sequence
    /edit/init?n=256          build the ARAP drag-edit session (FPS control points)
    /edit/pick?x=&y=&az=&el=&r=[&expand=1]   select the control point near a pixel
    /edit/drag?dx=&dy=&az=&el=&r=            drag the selected handles (pixels), re-solve
    /edit/clear               reset the edit session
        the edited cloud renders with  /render?...&mode=edited

Every frame renders through ``render/api.py:render`` at the reference's
fixed window (``max_per_tile=512``) wherever that window holds it, and is
then the reference's frame. The reference reads no overflow counter and
serves a frame whose window overflows truncated; here such a frame renders
again on a tile ladder fitted to its own tile counts, which the viewer keeps
for later frames (``FrameHolder``, which the pipeline twin's SIBR endpoint
renders through too, at its training window). Posed by ``skeleton_warp.pose_at`` /
``deform_by_pose`` (a stage-2 model) or ``node_warp.warp_forward`` (a
stage-1 model), coloured by ``eval/synthesis.py:skinning_colors`` in the
skinning mode. The model lives on ``device`` (the card unless given); a
frame is quantized there and read once.

Each ``/render`` reply carries the frame's overflow counters in its
``X-Overflow-Tiles`` and ``X-Overflow-Rect`` headers: 0 unless no window
up to ``train/stage2.py:window_ceiling`` holds the frame, which is then
served truncated with a warning.

Errors: a request whose parameters are missing or malformed, or that needs
``/edit/init`` first, gets 400; any other failure (a render, a kernel, a
solve) gets 500 with its message, and its traceback is printed, where the
reference answers 400 for every API error and drops the connection on a
failed render. A live viewer with no model yet answers ``/render`` with 503.

Usage:
    from riggs_tpu_torch.viz.web_viewer import ViewerServer
    ViewerServer(gs, skel=skel).serve(port=8080)   # a skeleton (stage-2) model
    ViewerServer(gs, warp=warp).serve(port=8080)   # a node (stage-1) model
    ViewerServer(state_fn=lambda: (gs, skel, warp), device=dev).serve(port=0, blocking=False)  # live, a free port
"""
from __future__ import annotations

import io
import json
import sys
import tempfile
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from riggs_tpu_torch import trace
from riggs_tpu_torch.camera.camera import Camera, make_camera
from riggs_tpu_torch.device import resolve_device
from riggs_tpu_torch.edit.pose_edit import PoseLibrary, retarget_pose, rotate_joint
from riggs_tpu_torch.edit.session import EditSession
from riggs_tpu_torch.eval.synthesis import skinning_colors
from riggs_tpu_torch.models import node_warp as NW
from riggs_tpu_torch.models import skeleton_warp as SW
from riggs_tpu_torch.render.api import render
from riggs_tpu_torch.render.binning import TILE
from riggs_tpu_torch.render.ladder import LadderPolicy
from riggs_tpu_torch.train.stage2 import escalate_rect, window_ceiling
from riggs_tpu_torch.viz.sibr import quantize

VIEW_WINDOW = 512  # the reference viewer's fixed max_per_tile

_PAGE = """<!DOCTYPE html>
<html><head><title>riggs_tpu viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace}
#c{display:block;margin:8px auto;border:1px solid #333}
#bar{ text-align:center; padding:4px }
button,input,select{background:#222;color:#ddd;border:1px solid #444;margin:2px}
</style></head><body>
<div id="bar">
 t:<input id="t" type="range" min="0" max="1" step="0.01" value="0" style="width:200px">
 mode:<select id="mode"><option>rgb</option><option>skinning</option><option>motion</option><option>edited</option></select>
 joint:<input id="joint" type="number" value="-1" style="width:50px">
 angle:<input id="angle" type="range" min="-180" max="180" value="0" style="width:150px">
 <button onclick="reset()">reset pose</button>
 <label><input id="edit" type="checkbox">edit</label>
 <button onclick="editInit()">init edit</button>
 <button onclick="editClear()">clear edit</button>
 <button onclick="poseSave()">save pose</button>
 <button onclick="posePlay()">play</button>
 <span id="stat"></span>
</div>
<canvas id="c" width="512" height="512"></canvas>
<script>
let az=0, el=0.3, radius=3.0, drag=false, lx=0, ly=0, pending=false, seq=-1, playing=null;
const c=document.getElementById('c'), ctx=c.getContext('2d');
const v=id=>document.getElementById(id).value;
const editOn=()=>document.getElementById('edit').checked;
function refresh(){
  if(pending) return; pending=true;
  const img=new Image();
  const t0=performance.now();
  img.onload=()=>{ctx.drawImage(img,0,0,c.width,c.height);pending=false;
    document.getElementById('stat').textContent=(performance.now()-t0).toFixed(0)+' ms';};
  img.onerror=()=>{pending=false};
  const s=seq>=0?`&seq=${seq}`:'';
  img.src=`/render?az=${az}&el=${el}&r=${radius}&t=${v('t')}&mode=${v('mode')}&joint=${v('joint')}&angle=${v('angle')}${s}&_=${Date.now()}`;
}
function reset(){document.getElementById('angle').value=0;document.getElementById('joint').value=-1;seq=-1;
  fetch('/pose/clear').then(refresh);}
function editInit(){fetch('/edit/init').then(()=>{document.getElementById('edit').checked=true;
  document.getElementById('mode').value='edited';refresh();});}
function editClear(){fetch('/edit/clear').then(refresh);}
function poseSave(){const n=prompt('pose name'); if(n) fetch(`/pose/save?name=${n}`);}
function posePlay(){
  fetch('/pose/list').then(r=>r.json()).then(names=>{
    const ns=prompt('poses to play (comma-sep)', names.join(','));
    if(!ns) return;
    fetch(`/pose/play?names=${ns}&frames=15`).then(r=>r.json()).then(o=>{
      let i=0; if(playing) clearInterval(playing);
      playing=setInterval(()=>{seq=i++%o.frames; refresh();}, 120);
    });});
}
c.onmousedown=e=>{
  drag=true;lx=e.clientX;ly=e.clientY;
  if(editOn()&&e.shiftKey){
    const r=c.getBoundingClientRect();
    const x=(e.clientX-r.left)*(c.width/r.width), y=(e.clientY-r.top)*(c.height/r.height);
    fetch(`/edit/pick?x=${x}&y=${y}&az=${az}&el=${el}&r=${radius}`).then(refresh);
  }};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-lx, dy=e.clientY-ly; lx=e.clientX; ly=e.clientY;
  if(editOn()){fetch(`/edit/drag?dx=${dx}&dy=${dy}&az=${az}&el=${el}&r=${radius}`).then(refresh);}
  else{az+=dx*0.01;el+=dy*0.01;refresh();}};
c.onwheel=e=>{e.preventDefault();radius*=Math.pow(1.1,e.deltaY>0?1:-1);refresh()};
document.getElementById('t').oninput=refresh;
document.getElementById('mode').onchange=refresh;
document.getElementById('angle').oninput=refresh;
setInterval(()=>{},1000); refresh();
</script></body></html>"""


class BadRequest(ValueError):
    """A request the viewer cannot serve as asked (400)."""


class NoModel(RuntimeError):
    """A live viewer asked to render before its first state (503)."""


def _arg(q: dict, name: str, kind=float, default=None):
    """Query parameter ``name`` as ``kind`` (int parses through float, as
    the reference's ``int(float(...))``); a missing one takes ``default``,
    or is a BadRequest when there is none."""
    if name not in q:
        if default is None:
            raise BadRequest(f"missing parameter {name!r}")
        return default
    try:
        return int(float(q[name])) if kind is int else kind(q[name])
    except ValueError as e:
        raise BadRequest(f"parameter {name!r}: {e}") from None


def _view(q: dict) -> tuple[float, float, float]:
    return _arg(q, "az", float, 0.0), _arg(q, "el", float, 0.3), _arg(q, "r", float, 3.0)


class FrameHolder:
    """``render``'s frame at a fixed window wherever that window holds it.
    A frame it does not hold renders again on a tile ladder fitted to its
    own tile counts (the binner counts them before truncation). The ladder
    stays for later frames, which render on it first. A frame that
    overflows it refits it, as ``LadderPolicy`` does in the loops; a frame
    whose largest tile fits the window drops it. A rect overflow raises the
    rect cap (``escalate_rect``). The caps stop at ``window_ceiling`` and
    ``MAX_TILES_LIMIT``; a frame they do not hold is returned truncated,
    with a warning. The counters are read once a render, into
    ``overflow``. Under the profiler each render counts in
    ``frame_renders`` and each copy to the host in ``host_reads``
    (``riggs_tpu_torch.trace``)."""

    def __init__(self, window: int):
        self.window = window
        self.ladder = None  # the LadderPolicy of frames ``window`` does not hold
        self.overflow = {"overflow_tiles": 0, "overflow_rect": 0}  # the last frame's counters

    def __call__(self, cam, gs, bg, **kw) -> torch.Tensor:
        n_tiles = -(-cam.width // TILE) * -(-cam.height // TILE)
        max_tiles = 16
        while True:
            out = render(cam, gs, bg, max_per_tile=self.window, max_tiles_per_gaussian=max_tiles,
                         tile_ladder=None if self.ladder is None else self.ladder.ladder, **kw)
            trace.count("frame_renders")
            trace.count("host_reads")
            of_t, of_r, max_count = torch.stack(
                [out[k].to(torch.int64) for k in ("overflow_tiles", "overflow_rect", "max_count")]).tolist()
            if self.ladder is not None and max_count <= self.window:
                self.ladder = None  # the window holds this frame: its single render
                continue
            if of_t == 0 and of_r == 0:
                break
            grown = False
            if of_t > 0:
                if self.ladder is None:
                    self.ladder = LadderPolicy(n_probe=1, max_cap=window_ceiling(gs.device, n_tiles))
                old = self.ladder.ladder
                trace.count("host_reads")
                self.ladder.observe(out["tile_counts"].cpu().numpy(), of_t)
                grown = self.ladder.ladder != old
            caps = escalate_rect(of_t, of_r, grown, max_tiles, what="a viewer frame")
            if caps is None:
                break
            max_tiles = caps[0]
        self.overflow = {"overflow_tiles": of_t, "overflow_rect": of_r}
        return out["render"]


class ViewerServer:
    def __init__(self, gs=None, skel=None, warp=None, width: int = 512, height: int = 512, fov: float = 0.9,
                 state_fn=None, pose_lib_path=None, device: str | torch.device | None = None):
        """A static model: ``gs`` with ``skel`` or ``warp``. Live training:
        ``state_fn() -> (gs, skel, warp)``, called on every request, so that
        the viewer renders the current training state. The model's tensors
        live on ``device`` (the card unless given)."""
        self._static = (gs, skel, warp)
        self.state_fn = state_fn
        self.width = width
        self.height = height
        self.fov = fov
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        if pose_lib_path is None:
            pose_lib_path = Path(tempfile.gettempdir()) / "riggs_viewer_poses.json"
        self.pose_lib = PoseLibrary(pose_lib_path)
        self.edit = None  # EditSession after /edit/init
        self._seq = None  # (rotations (F, J, 4), translations (F, 3)) playback, on the device
        self._pose_override = None  # (local_rotation, global_trans) from /retarget, on the device
        self.httpd = None  # the HTTP server once serve() runs
        self.frames = FrameHolder(VIEW_WINDOW)  # renders every frame; its ladder and last counters

    @property
    def _state(self):
        return self.state_fn() if self.state_fn is not None else self._static

    @property
    def gs(self):
        return self._state[0]

    @property
    def skel(self):
        return self._state[1]

    @property
    def warp(self):
        return self._state[2]

    # ---- rendering -------------------------------------------------------
    def _pose_np(self, az: float, el: float, radius: float) -> tuple[np.ndarray, np.ndarray]:
        """The orbit camera's (R, T): camera-to-world R, world-to-camera T."""
        pos = radius * np.array([np.cos(el) * np.cos(az), np.sin(el), np.cos(el) * np.sin(az)])
        z = -pos / np.linalg.norm(pos)
        up = np.array([0.0, -1.0, 0.0])
        x = np.cross(up, z)
        x /= max(np.linalg.norm(x), 1e-9)
        y = np.cross(z, x)
        R = np.stack([x, y, z], axis=1)
        return R, -R.T @ pos

    def _camera(self, az: float, el: float, radius: float) -> Camera:
        R, T = self._pose_np(az, el, radius)
        return make_camera(R, T, self.width, self.height, fovx=self.fov, fovy=self.fov, device=self.device)

    def current_pose(self, az, el, radius, t, joint=-1, angle=0.0, seq=-1) -> tuple[torch.Tensor, torch.Tensor]:
        """(local_rotation, global_trans) after the sequence, the override
        and the joint edit: what /render poses with."""
        skel = self.skel
        if self._seq is not None and 0 <= seq < self._seq[0].shape[0]:
            rot, trans = self._seq[0][seq], self._seq[1][seq]
        elif self._pose_override is not None:
            rot, trans = self._pose_override
        else:
            pose = SW.pose_at(skel, float(t))
            rot, trans = pose["local_rotation"], pose["global_trans"]
        if 0 <= joint < skel.net.n_joints and abs(angle) > 1e-3:
            view_axis = self._pose_np(az, el, radius)[0][:, 2]  # the camera's forward axis in world
            rot = rotate_joint(rot, int(joint), view_axis, float(np.deg2rad(angle)))
        return rot, trans

    @torch.no_grad()
    def render_frame(self, az, el, radius, t, mode="rgb", joint=-1, angle=0.0, seq=-1) -> torch.Tensor:
        """The (H, W, 3) float frame on the model's device (``FrameHolder``)."""
        with trace.span("riggs.entry.frame"):
            gs, skel, warp = self._state
            if gs is None:
                raise NoModel("no model to render yet")
            cam = self._camera(az, el, radius)
            bg = torch.zeros(3, device=gs.device)
            if mode == "edited" and self.edit is not None:
                return self.frames(cam, gs, bg, d_xyz=self.edit.d_xyz, active_sh_degree=gs.max_sh_degree)
            if skel is not None:
                with trace.span("riggs.deform.skeleton"):
                    rot, trans = self.current_pose(az, el, radius, t, joint, angle, seq)
                    d = SW.deform_by_pose(skel, gs.xyz, rot, trans, gs.motion_mask)
            elif warp is not None:
                with trace.span("riggs.deform.nodes"):
                    d = NW.warp_forward(warp, gs.xyz, float(t), gs.feature, gs.motion_mask)
            else:
                d = None
            common = {} if d is None else dict(d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                                               d_scaling=torch.zeros_like(d["d_scaling"]))
            if mode == "skinning" and d is not None and skel is not None:
                colors = skinning_colors(d["nn_idx"], d["nn_weight"], skel.net.n_joints)
                return self.frames(cam, gs, bg, override_color=colors, **common)
            if mode == "motion":
                return self.frames(cam, gs, bg, render_motion=True, **common)
            return self.frames(cam, gs, bg, active_sh_degree=gs.max_sh_degree, **common)

    # ---- editing / pose API ---------------------------------------------
    def handle_api(self, path: str, q: dict):
        """The JSON endpoints (see the module docstring): a JSON-able reply,
        or None for an unknown path (404); raises BadRequest for a request
        it cannot serve (400)."""
        if path == "/pose/save":
            az, el, r = _view(q)
            name = _arg(q, "name", str)
            rot, trans = self.current_pose(az, el, r, _arg(q, "t", float, 0.0), _arg(q, "joint", int, -1),
                                           _arg(q, "angle", float, 0.0), _arg(q, "seq", int, -1))
            self.pose_lib.add(name, rot, trans)
            self.pose_lib.save()
            return {"saved": name}
        if path == "/pose/list":
            return sorted(self.pose_lib.poses)
        if path == "/pose/play":
            names = [n for n in q.get("names", "").split(",") if n]
            missing = [n for n in names if n not in self.pose_lib.poses]
            if missing or len(names) < 2:
                raise BadRequest(f"need two or more saved poses; unknown {missing}")
            self._seq = self.pose_lib.interpolate(names, _arg(q, "frames", int, 15), device=self.device)
            return {"frames": int(self._seq[0].shape[0])}
        if path == "/pose/clear":
            self._seq = None
            self._pose_override = None
            return {"ok": True}
        if path == "/retarget":
            src_dir = Path(_arg(q, "path", str))
            name = _arg(q, "name", str)
            try:
                tree = np.load(src_dir / "skeleton_tree.npz")
                rot, trans = PoseLibrary(src_dir / "poses.json").get(name)
            except (OSError, KeyError) as e:
                raise BadRequest(f"retarget from {src_dir}: {e!r}") from None
            dst = self.skel.joints.cpu().numpy()
            rot, trans = retarget_pose(tree["joints"], dst, rot, trans)
            self._pose_override = (torch.as_tensor(rot, device=self.device),
                                   torch.as_tensor(trans, device=self.device))
            return {"joints_src": int(tree["joints"].shape[0]), "joints_dst": int(dst.shape[0])}
        if path == "/edit/init":
            n = _arg(q, "n", int, 256)
            ctrl = None if self.warp is None else self.warp.nodes[:, :3].detach()
            self.edit = EditSession(self.gs.xyz.detach(), n_ctrl=n, ctrl_points=ctrl, device=self.device)
            return {"n_ctrl": int(self.edit.ctrl_rest.shape[0])}
        if path == "/edit/pick":
            if self.edit is None:
                raise BadRequest("call /edit/init first")
            cam = self._camera(*_view(q))
            i = self.edit.pick(cam, _arg(q, "x"), _arg(q, "y"), expand=bool(_arg(q, "expand", int, 0)))
            return {"picked": i, "n_keypoints": len(self.edit.kps)}
        if path == "/edit/drag":
            if self.edit is None:
                raise BadRequest("call /edit/init first")
            cam = self._camera(*_view(q))
            self.edit.drag(cam, _arg(q, "dx"), _arg(q, "dy"))
            return {"n_keypoints": len(self.edit.kps)}
        if path == "/edit/clear":
            if self.edit is not None:
                self.edit.clear()
            return {"ok": True}
        return None

    def render_png(self, q: dict) -> bytes:
        """/render's reply: the frame of the query, quantized, as a PNG."""
        from PIL import Image

        az, el, r = _view(q)
        img = self.render_frame(az, el, r, _arg(q, "t", float, 0.0), q.get("mode", "rgb"), _arg(q, "joint", int, -1),
                                _arg(q, "angle", float, 0.0), _arg(q, "seq", int, -1))
        buf = io.BytesIO()
        Image.fromarray(quantize(img)).save(buf, "PNG")
        return buf.getvalue()

    # ---- http ------------------------------------------------------------
    def serve(self, port: int = 8080, blocking: bool = True) -> ThreadingHTTPServer:
        """Serve on ``port`` (0: a free one, ``self.httpd.server_address``
        says which); blocks unless ``blocking`` is False, then serves from a
        daemon thread. Returns the server (``shutdown()`` stops it)."""
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code: int, ctype: str | None, body: bytes = b"", headers: dict | None = None):
                self.send_response(code)
                if ctype is not None:
                    self.send_header("Content-Type", ctype)
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                if u.path == "/":
                    self._reply(200, "text/html", _PAGE.encode())
                    return
                headers = None
                try:
                    with viewer._lock:
                        if u.path == "/render":
                            body, ctype = viewer.render_png(q), "image/png"
                            headers = {"X-Overflow-Tiles": viewer.frames.overflow["overflow_tiles"],
                                       "X-Overflow-Rect": viewer.frames.overflow["overflow_rect"]}
                        else:
                            out = viewer.handle_api(u.path, q)
                            if out is None:
                                self._reply(404, None)
                                return
                            body, ctype = json.dumps(out).encode(), "application/json"
                except (BadRequest, NoModel) as e:
                    code = 400 if isinstance(e, BadRequest) else 503
                    self._reply(code, "application/json", json.dumps({"error": str(e)}).encode())
                    return
                except Exception as e:  # noqa: BLE001 -- a failure of the program, answered and shown
                    traceback.print_exc(file=sys.stderr)
                    self._reply(500, "application/json", json.dumps({"error": repr(e)}).encode())
                    return
                self._reply(200, ctype, body, headers)

        server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.httpd = server
        print(f"viewer at http://localhost:{server.server_address[1]}/", flush=True)
        if blocking:
            server.serve_forever()
        else:
            threading.Thread(target=server.serve_forever, daemon=True).start()
        return server

    def shutdown(self) -> None:
        """Stop serving and close the socket."""
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
