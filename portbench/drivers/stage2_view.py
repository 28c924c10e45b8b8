"""A trained skeleton model served frame by frame: one client in a closed
loop calling the viewer's ``ViewerServer.render_frame`` (every frame
through ``FrameHolder``, which renders the frame again on a tile ladder
where the viewer's window of 512 does not hold it, and keeps and refits
that ladder as the view turns), each frame copied to host memory as
``/render`` takes it (``viz/sibr.py:quantize``, without the PNG encode)
before the next request is sent.

Set-up builds the model from the seed and serves the first
``warm_frames`` requests. The check compares ``check_frames`` requests
drawn from the seed among the ``check_window`` served next (one with a
joint edit among them) with the plain reference: the pose, the skinning,
the offsets and the delivered frame.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import harness, program, roofline, scene
from portbench.reference import model as RM
from portbench.reference import render as RR


class Driver:
    unit = "frame"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, torch.device(device)

    def setup(self, cache_dir=None):
        from riggs_tpu_torch.models import skeleton_warp as SW
        from riggs_tpu_torch.viz.web_viewer import ViewerServer

        cfg, dev, tr = self.cfg, self.dev, self.traffic
        self.avatar = scene.make_gaussians(cfg, self.seed, dev)
        self.weights = scene.make_skeleton_weights(cfg, self.seed, self.avatar["joints"], dev)
        gs = program.gaussians(self.avatar, cfg["avatar"]["sh_degree"])
        skel = program.skeleton(self.avatar["joints"], self.weights, cfg, dev)
        v = cfg["view"]
        lib = None if cache_dir is None else cache_dir / "viewer_poses.json"
        self.viewer = ViewerServer(gs, skel, width=v["size"], height=v["size"], fov=v["fov"], pose_lib_path=lib,
                                   device=dev)
        self.requests = scene.view_requests(tr, self.seed, tr["max_frames"], len(scene.PARENTS))
        rng = scene.host_rng(self.seed, 7)
        pool = np.arange(tr["warm_frames"], tr["warm_frames"] + tr["check_window"])
        edited = int(rng.choice([i for i in pool if self.requests[i]["joint"] >= 0]))
        rest = rng.choice(pool[pool != edited], tr["check_frames"] - 1, replace=False)
        self.sample = sorted([edited] + [int(i) for i in rest])
        self.capture = program.Capture({"deform": (SW, "deform_by_pose", program.DEFORM_KEYS)})
        self.kept: dict[int, dict] = {}
        self.k = 0
        self._ctx = self.capture.installed()
        self._ctx.__enter__()
        self.setup_rec = {"attempted": 0, "failed": 0, "latency_s": [], "host_s": [], "requests": []}
        for _ in range(tr["warm_frames"]):
            self._serve(self.setup_rec)
        harness.sync(dev)

    def _serve(self, rec):
        from riggs_tpu_torch.viz.sibr import quantize

        if self.k >= len(self.requests):
            raise RuntimeError(f"the traffic's max_frames ({len(self.requests)}) ran out inside the window")
        i, q = self.k, self.requests[self.k]
        keep = i in self.sample
        self.capture.armed = keep
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.frame"):
            img = self.viewer.render_frame(q["az"], q["el"], q["r"], q["t"], "rgb", q["joint"], q["angle"])
            rec["host_s"].append(time.perf_counter() - t0)
            bad = torch.isnan(img).any()
            host = quantize(img)
        rec["latency_s"].append(time.perf_counter() - t0)
        self.capture.armed = False
        of = self.viewer.frames.overflow
        rec["failed"] += int(bool(bad) or of["overflow_tiles"] > 0 or of["overflow_rect"] > 0 or host.size == 0)
        rec["attempted"] += 1
        rec["requests"].append(i)
        if keep:
            self.kept[i] = {"image": img.detach().clone(), "deform": self.capture.records["deform"][-1]}
        self.k += 1

    def run(self, seconds: float | None = None, units: int | None = None) -> dict:
        rec = {"attempted": 0, "failed": 0, "latency_s": [], "host_s": [], "requests": []}
        t0 = time.perf_counter()
        while (rec["attempted"] < units) if units is not None else (time.perf_counter() - t0 < seconds):
            self._serve(rec)
        harness.sync(self.dev)
        rec["window_s"] = time.perf_counter() - t0
        return rec

    def end_to_end(self, rec: dict) -> dict:
        lat = sorted(rec["latency_s"])
        p95 = float(np.percentile(np.asarray(lat), 95.0)) * 1e3
        return {"frames_per_s": rec["attempted"] / rec["window_s"], "frame_ms_p95": p95}

    @torch.no_grad()
    def layer_context(self, rec: dict, trace) -> harness.LayerContext:
        """The work of the traced frames from their requests: the skeleton
        model's forward FLOPs on the alive points and the blend forward's
        pairs, projected by the reference."""
        n_alive = int(self.avatar["alive"].sum())
        flops, bounds = 0.0, {"blend_fwd": 0.0}
        per_frame = roofline.skeleton_flops(self.cfg, n_alive, len(scene.PARENTS))
        for i in rec["requests"]:
            out = self._reference(self.requests[i], with_lists=True)
            gid, starts, counts, tx, packed = out["lists"]
            w = roofline.walk(packed, gid, starts, counts, tx, out["width"], out["height"])
            bounds["blend_fwd"] += roofline.blend_bounds(w)["blend_fwd"]
            flops += per_frame + roofline.blend_flops(w, backward=False)
        return harness.LayerContext(trace=trace, units=rec["attempted"], host_s=rec["host_s"], flops=flops,
                                    bounds_ms=bounds, kernel_match={"blend_fwd": harness.blend_fwd})

    def _reference(self, q: dict, with_lists=False) -> dict:
        """The reference's frame of request ``q``: its pose (the joint edit
        about the view axis), dense skinning with the offsets, the render."""
        v, dev = self.cfg["view"], self.dev
        R, T = scene.orbit_pose(q["az"], q["el"], q["r"])
        w2c, intr = scene.camera_arrays(R, T, v["size"], v["size"], v["fov"], v["fov"])
        w2c, intr = torch.tensor(w2c, device=dev), torch.tensor(intr, device=dev)
        rot, trans = RM.pose_at(self.weights, torch.tensor(q["t"], dtype=torch.float32, device=dev), self.cfg["skeleton"])
        if 0 <= q["joint"] < len(scene.PARENTS) and abs(q["angle"]) > 1e-3:
            rot = RM.rotate_joint(rot, q["joint"], R[:, 2], float(np.deg2rad(q["angle"])))
        p = self.avatar["params"]
        d = RM.deform(self.weights, self.avatar["joints"], scene.PARENTS, p["xyz"], rot, trans,
                      torch.sigmoid(p["feature"][:, -1:]), self.cfg["skeleton"])
        out = RR.render(p, self.avatar["alive"], d["d_xyz"], d["d_rotation"], w2c, intr, v["size"], v["size"],
                        torch.zeros(3, device=dev), with_lists=with_lists)
        out.update(deform=d, width=v["size"], height=v["size"])
        return out

    def release(self):
        self._ctx.__exit__(None, None, None)
        self.__dict__.pop("viewer", None)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def readings(self, rec: dict, control: bool = False) -> dict:
        """Every number the check compares over the sampled requests served
        after set-up: the frame, the pose, the skinned positions and the
        template offsets, program against reference; with ``control``, the
        reference in TF32 in the program's place."""
        served = set(self.kept)  # the sampled requests served after set-up (a traced run's warm units too)
        r = {"frame": 0.0, "frame_p999": 0.0, "pose": 0.0, "deform": 0.0, "offsets": 0.0, "compared": 0}
        for i in self.sample:
            if i not in served:
                continue
            ref = self._reference(self.requests[i])
            if control:
                with harness.tf32():
                    low = self._reference(self.requests[i])
                got = {"image": low["image"], "deform": low["deform"]}
            else:
                got = self.kept[i]
            d, dr = got["deform"], ref["deform"]
            r["frame"] = max(r["frame"], float((got["image"] - ref["image"]).abs().max()))
            r["frame_p999"] = max(r["frame_p999"], program.p999_gap(got["image"], ref["image"]))
            r["pose"] = max(r["pose"], program.gap(d["local_rotation"], dr["local_rotation"]),
                            program.gap(d["global_trans"], dr["global_trans"]))
            r["deform"] = max(r["deform"], program.gap(d["d_xyz"], dr["d_xyz"]))
            r["offsets"] = max(r["offsets"], program.gap(d["template_offsets"], dr["template_offsets"]))
            r["compared"] += 1
        return r

    def control_readings(self, rec: dict) -> dict:
        return self.readings(rec, control=True)
