"""What the training cells share: a loop of the program's auto steps
entered at the schedule's steady tail, and its check against the plain
reference.

Set-up builds the program's training state from the seed (a driver's
``build``), fits the tile ladder to every train frame's tile counts
(``LadderPolicy``, one probe render a frame at the initial state) and runs
the first steps through the window's own call, keeping the Adam moments
after the first and the parameters after the last, with the deformation
and the render each step produced. The window continues the same state:
one frame a step in a seeded order, each step's overflow counters and loss
read one step late (as the program's loops read them), the ladder checked
every ``ladder_check_every`` steps and refitted on overflow.

The check follows the first steps with the reference from the seed's
weights and compares each step's loss, its render and deformation, the
first gradient's norm by leaf and the parameters' change by leaf.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import harness, program, roofline, scene
from portbench.reference import render as RR
from portbench.reference import train as RT

B1 = 0.9  # Adam's first-moment decay: after one step mu = (1 - B1) g


class TrainDriver:
    unit = "step"
    model_key = ""  # the model's key in the parameter trees ("skel", "warp")

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, torch.device(device)

    # ---- what a driver supplies --------------------------------------------
    def build(self):
        """Set ``self.state``, ``self.step_fn``, ``self.capture`` and
        ``self.weights`` (the seed's model weights)."""
        raise NotImplementedError

    def call_step(self, frame, uid: int):
        """One program step on ``frame``; returns its metrics."""
        raise NotImplementedError

    def probe(self, frame):
        """The program's render of ``frame`` at the current state (its tile counts)."""
        raise NotImplementedError

    def params(self) -> dict:
        """The program's parameters {"gs": ..., model_key: ...}."""
        raise NotImplementedError

    def moments(self) -> dict:
        """The program's first Adam moments, in the parameters' tree."""
        raise NotImplementedError

    def reference_loss(self, params: dict, k: int, uid: int, carry: dict):
        """The reference's loss of step ``k`` on frame ``uid``: (loss, render,
        deformation, carry for the next step)."""
        raise NotImplementedError

    def reference_lrs(self, it: int) -> dict:
        raise NotImplementedError

    def reference_deform(self, params: dict, frame: dict) -> dict:
        """The reference's deformation of the Gaussians at ``frame``."""
        raise NotImplementedError

    def model_flops(self, n_points: int) -> float:
        """Forward FLOPs of the deformation on ``n_points`` points."""
        raise NotImplementedError

    DEFORM_NUMBERS: tuple = ()  # (captured key, reading name)

    # ---- set-up -------------------------------------------------------------
    def setup(self, cache_dir=None):
        from riggs_tpu_torch.render.ladder import LadderPolicy

        cfg, dev = self.cfg, self.dev
        self.avatar = scene.make_gaussians(cfg, self.seed, dev)
        self.frames = scene.make_frames(cfg, self.seed, self.avatar["joints"], dev)
        self.order = scene.frame_order(self.seed, self.frames.fid.shape[0], self.traffic["max_steps"])
        self.pcfg = program.config(cfg)
        self.pframes = program.train_frames(self.frames)
        self.bg = torch.ones(3, device=dev) if cfg["frames"]["background"] == "white" else torch.zeros(3, device=dev)
        pipe = self.pcfg.pipe
        self.tiers = (pipe.max_tiles_per_gaussian, pipe.mid_cap, pipe.mid_side)
        self.build()
        self.it, self.k = self.traffic["start_it"], 0
        with torch.no_grad():
            counts = torch.stack([self.probe(fr)["tile_counts"] for fr in self.pframes])
        self.policy = LadderPolicy(n_buckets=pipe.ladder_buckets, margin=pipe.ladder_margin, n_probe=1)
        self.policy.observe(counts.cpu().numpy())
        self.ladder = self.policy.ladder
        self.losses, self.setup_rec = [], {"attempted": 0, "failed": 0}
        with self.capture.installed():
            self.capture.armed = True
            for k in range(self.traffic["first_steps"]):
                m = self._step()
                self.losses.append(m["loss"].detach().clone())
                self.setup_rec["attempted"] += 1
                self.setup_rec["failed"] += self._read(m)[0]
                if k == 0:
                    self.mu1 = program.clone_tree(self.moments())
            self.capture.armed = False
        self.p_first = program.clone_tree(self.params())
        harness.sync(dev)

    def _step(self):
        uid = int(self.order[self.k])
        m = self.call_step(self.pframes[uid], uid)
        self.it += 1
        self.k += 1
        return m

    @staticmethod
    def _read(m) -> tuple[int, int]:
        """(failed, overflow_tiles) of a step's metrics, in one copy."""
        of_t, of_r, bad = torch.stack([m["overflow_tiles"].to(torch.int64), m["overflow_rect"].to(torch.int64),
                                       (~torch.isfinite(m["loss"])).to(torch.int64)]).tolist()
        return int(of_t > 0 or of_r > 0 or bad > 0), of_t

    def _late_read(self, it, m, rec):
        """The previous step's counters and loss; the ladder checked at the
        program's cadence and refitted on overflow."""
        failed, of_t = self._read(m)
        rec["failed"] += failed
        if of_t > 0 or it % self.pcfg.pipe.ladder_check_every == 0:
            self.policy.observe(m["tile_counts"].cpu().numpy(), of_t)
            rec["refits"] += int(self.policy.ladder != self.ladder)
            self.ladder = self.policy.ladder

    # ---- the window -----------------------------------------------------------
    def run(self, seconds: float | None = None, units: int | None = None) -> dict:
        rec = {"attempted": 0, "failed": 0, "refits": 0, "host_s": [], "frames": []}
        prev = None
        t0 = time.perf_counter()
        while (rec["attempted"] < units) if units is not None else (time.perf_counter() - t0 < seconds):
            if self.k >= len(self.order):
                raise RuntimeError(f"the traffic's max_steps ({len(self.order)}) ran out inside the window")
            it, uid = self.it, int(self.order[self.k])
            with torch.profiler.record_function("portbench.step"):
                h = time.perf_counter()
                m = self._step()
                rec["host_s"].append(time.perf_counter() - h)
            rec["frames"].append(uid)
            rec["attempted"] += 1
            if prev is not None:
                with torch.profiler.record_function("portbench.late_read"):
                    self._late_read(*prev, rec)
            prev = (it, m)
        self._late_read(*prev, rec)
        harness.sync(self.dev)
        rec["window_s"] = time.perf_counter() - t0
        return rec

    def end_to_end(self, rec: dict) -> dict:
        return {"train_step_ms": rec["window_s"] / rec["attempted"] * 1e3}

    # ---- the work of the traced steps ------------------------------------------
    @torch.no_grad()
    def layer_context(self, rec: dict, trace) -> harness.LayerContext:
        """The work of the traced steps, counted from their inputs: the
        deformation's FLOPs (forward and backward, 3x) on the alive points
        and the blend's pairs of each traced frame, projected by the
        reference from the state after the window (some steps later: the
        tail's learning rates move the pairs by far less than the kernels'
        times spread)."""
        params = program.clone_tree(self.params())
        alive = self.avatar["alive"]
        per_step = 3 * self.model_flops(int(alive.sum()))
        flops, bounds = 0.0, {"blend_fwd": 0.0, "blend_bwd": 0.0}
        for uid in rec["frames"]:
            f = self.ref_frame(uid)
            d = self.reference_deform(params, f)
            out = RR.render(params["gs"], alive, d["d_xyz"], d["d_rotation"], f["w2c"], f["intr"], f["width"],
                            f["height"], f["bg"], with_lists=True)
            gid, starts, counts, tiles_x, packed = out["lists"]
            w = roofline.walk(packed, gid, starts, counts, tiles_x, f["width"], f["height"])
            b = roofline.blend_bounds(w)
            bounds["blend_fwd"] += b["blend_fwd"]
            bounds["blend_bwd"] += b["blend_bwd"]
            flops += per_step + roofline.blend_flops(w, backward=True)
        return harness.LayerContext(trace=trace, units=rec["attempted"], host_s=rec["host_s"], flops=flops,
                                    bounds_ms=bounds,
                                    kernel_match={"blend_fwd": harness.blend_fwd, "blend_bwd": harness.blend_bwd})

    def ref_frame(self, uid: int) -> dict:
        fr = self.frames
        return {"w2c": fr.w2c[uid], "intr": fr.intrinsics[uid], "fid": fr.fid[uid], "image": fr.image[uid],
                "thinned": fr.thinned[uid], "thinned_mask": fr.thinned_mask[uid], "width": fr.width,
                "height": fr.height, "bg": self.bg}

    # ---- the check ------------------------------------------------------------
    def release(self):
        """Free the program's state before the reference runs."""
        for name in ("state", "step_fn", "pframes", "program_extra"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def seed_params(self) -> dict:
        return {"gs": self.avatar["params"], self.model_key: self.weights}

    def reference_steps(self, n: int) -> dict:
        """The reference's first ``n`` steps from the seed's weights, on the
        frames the program's first steps took."""
        params = RT.tree_map(lambda v: v.clone().requires_grad_(True), self.seed_params())
        mu = RT.tree_map(torch.zeros_like, params)
        nu = RT.tree_map(torch.zeros_like, params)
        out, carry = {"loss": [], "render": [], "deform": []}, {}
        for k in range(n):
            uid = int(self.order[k])
            loss, ren, d, carry = self.reference_loss(params, k, uid, carry)
            flat = RT.leaves(params)
            grads = torch.autograd.grad(loss, [t for _, t in flat], allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g for (_, t), g in zip(flat, grads)]
            it_g = iter(grads)
            g_tree = RT.tree_map(lambda _: next(it_g), params)
            if k == 0:
                out["grad1"] = {p: g.detach() for (p, _), g in zip(flat, grads)}
            with torch.no_grad():
                new, mu, nu = RT.adam(g_tree, mu, nu, RT.tree_map(lambda v: v.detach(), params),
                                      self.reference_lrs(self.traffic["start_it"] + k), k + 1)
            params = RT.tree_map(lambda v: v.requires_grad_(True), new)
            out["loss"].append(float(loss.detach()))
            out["render"].append({"render": ren["image"].detach(), "alpha": ren["alpha"].detach(),
                                  "depth": ren["depth"].detach()})
            out["deform"].append({key: v.detach() for key, v in d.items()})
            del loss, ren, d, grads
        out["params"] = {p: t.detach() for p, t in RT.leaves(params)}
        out["carry"] = carry
        return out

    def program_side(self) -> dict:
        """What the program's first steps produced, in the reference's form:
        the first gradient from the Adam moment after one step."""
        return {"loss": [float(x) for x in self.losses], "render": self.capture.records["render"],
                "deform": self.capture.records["deform"],
                "grad1": {p: t / (1.0 - B1) for p, t in RT.leaves(self.mu1)},
                "params": dict(RT.leaves(self.p_first))}

    def compare(self, side: dict, ref: dict) -> dict:
        """Every number the check compares, one side against the reference:
        the worst of the first steps for the loss, the render and the
        deformation (each the widest gap, and the 99.9th percentile's,
        ``program.p999_gap``); the worst leaf for the first gradient's norm,
        and the median leaf (``change``; the worst one beside it) for the
        norm of the parameters' change, leaves whose reference gradient is
        under a thousandth of the median leaf's left out of the change."""
        n = len(ref["loss"])
        r = {"loss": max(abs(side["loss"][k] - ref["loss"][k]) / abs(ref["loss"][k]) for k in range(n))}
        for key in ("render", "alpha", "depth"):
            r[key] = max(program.gap(side["render"][k][key], ref["render"][k][key]) for k in range(n))
            r[key + "_p999"] = max(program.p999_gap(side["render"][k][key], ref["render"][k][key]) for k in range(n))
        for key, name in self.DEFORM_NUMBERS:
            r[name] = max(program.gap(side["deform"][k][key], ref["deform"][k][key]) for k in range(n))
            r[name + "_p999"] = max(program.p999_gap(side["deform"][k][key], ref["deform"][k][key]) for k in range(n))
        r["grad"], r["grad_leaf"] = program.worst_leaf_gap(side["grad1"], ref["grad1"])
        p0 = dict(RT.leaves(self.seed_params()))
        dp = {p: side["params"][p] - p0[p] for p in p0}
        dr = {p: ref["params"][p] - p0[p] for p in p0}
        gnorm = {p: float(torch.linalg.norm(t)) for p, t in ref["grad1"].items()}
        med = float(np.median(list(gnorm.values())))
        moved = {p for p, v in gnorm.items() if v >= 1e-3 * med}
        r["change_worst"], r["change_leaf"] = program.worst_leaf_gap(dp, dr, keep=moved)
        r["change"] = program.median_leaf_gap(dp, dr, keep=moved)
        return r

    def readings(self, rec: dict) -> dict:
        return self.compare(self.program_side(), self.reference_steps(len(self.losses)))

    def control_readings(self, rec: dict) -> dict:
        """The control: the reference with TF32 matmuls in the program's place."""
        n = len(self.losses)
        with harness.tf32():
            low = self.reference_steps(n)
        return self.compare(low, self.reference_steps(n))
