"""Stage-1 phase-B training steps of the node model (``train/stage1.py``
``make_phase_b_auto``) at the schedule's steady tail, as ``training.py``
drives them; the check's reference is ``reference/node.py``."""
from __future__ import annotations

import torch

from portbench import program, roofline, scene, training
from portbench.reference import node as RN


class Driver(training.TrainDriver):
    model_key = "warp"
    DEFORM_NUMBERS = (("d_xyz", "deform"), ("d_nodes", "nodes"))

    def build(self):
        from riggs_tpu_torch.models import gaussians as G
        from riggs_tpu_torch.models import node_warp as NW
        from riggs_tpu_torch.models.deform_mlp import DeformNetworkDef
        from riggs_tpu_torch.train import stage1 as S1
        from riggs_tpu_torch.train.optim import adam_init

        cfg, dev, n = self.cfg, self.dev, self.cfg["nodes"]
        self.weights = scene.make_node_weights(cfg, self.seed, self.avatar, dev)
        gs = program.gaussians(self.avatar, cfg["avatar"]["sh_degree"])
        net = DeformNetworkDef(is_blender=True)
        if (net.depth, net.width, net.multires_x, net.t_multires, net.time_out) != (
                n["depth"], n["width"], n["x_multires"], n["t_multires"], n["time_out"]):
            raise ValueError(f"the program's DeformNetwork {net} is not the configuration's {n}")
        w = self.weights
        warp = NW.NodeWarp(w["nodes"].clone(), w["radius"].clone(), w["weight"].clone(), net, K=n["K"],
                           hyper_dim=n["hyper_dim"], d_rot_as_res=True,
                           generator=torch.Generator(device=dev).manual_seed(0)).replace_params(w)
        node_xyz = w["nodes"][:, :3].cpu().numpy()
        node_cap = n["node_num"] * self.pcfg.opt.node_max_num_ratio_during_init
        node_gs = G.create_from_pcd(node_xyz, node_xyz * 0, capacity=node_cap, max_sh_degree=0, isotropic=True,
                                    with_motion_mask=False, shared_scale=True, device=dev)
        self.state = S1.Stage1State(gs=gs, node_gs=node_gs, warp=warp, opt_gs=adam_init(gs.params_dict()),
                                    opt_node=adam_init(node_gs.params_dict()), opt_warp=adam_init(warp.params_dict()),
                                    stats_gs=G.init_densify_stats(gs.capacity, device=dev),
                                    stats_node=G.init_densify_stats(node_cap, device=dev),
                                    it=torch.tensor(self.traffic["start_it"], dtype=torch.int32, device=dev))
        self.step_fn = S1.make_phase_b_auto(self.pcfg)
        self.arap_gen = scene.generator(self.seed, 9, dev)
        self.arap_t = []
        self.capture = program.Capture({"deform": (NW, "warp_forward", ("d_xyz", "d_rotation", "d_nodes")),
                                        "render": (S1, "render", program.RENDER_KEYS)})

    def call_step(self, frame, uid):
        from riggs_tpu_torch.models import node_warp as NW

        arap_t = NW.arap_sample_times(self.arap_gen, device=self.dev)
        if self.capture.armed:
            self.arap_t.append(arap_t.clone())
        self.state, m = self.step_fn(self.state, frame, self.bg, arap_t, it=self.it, use_chamfer=True,
                                     use_motion_loss=False, use_flow_loss=False,
                                     lambda_dssim=self.pcfg.opt.lambda_dssim, max_per_tile=self.pcfg.pipe.max_per_tile,
                                     isotropic=False, tile_ladder=self.ladder)
        if self.capture.armed:
            self.arap.append(m["arap"].detach().clone())
        return m

    def setup(self, cache_dir=None):
        self.arap = []
        super().setup(cache_dir)

    def probe(self, frame):
        from riggs_tpu_torch.models import node_warp as NW
        from riggs_tpu_torch.render.api import render, tier_kwargs

        gs, warp = self.state.gs, self.state.warp
        d = NW.warp_forward(warp, gs.xyz, frame.fid, gs.feature, gs.motion_mask)
        return render(frame.cam, gs, self.bg, d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                      d_scaling=torch.zeros_like(d["d_scaling"]), active_sh_degree=gs.max_sh_degree,
                      max_per_tile=self.pcfg.pipe.max_per_tile, **tier_kwargs(self.tiers))

    def params(self):
        return {"gs": self.state.gs.params_dict(), "warp": self.state.warp.params_dict()}

    def moments(self):
        return {"gs": self.state.opt_gs.mu, "warp": self.state.opt_warp.mu}

    def reference_loss(self, params, k, uid, carry):
        loss, ren, d, arap, _ = RN.phase_b_loss(params["gs"], params["warp"], self.avatar["alive"], self.ref_frame(uid),
                                                self.arap_t[k], self.traffic["start_it"] + k, self.cfg)
        carry.setdefault("arap", []).append(float(arap.detach()))
        return loss, ren, d, carry

    def program_side(self):
        return dict(super().program_side(), carry={"arap": [float(a) for a in self.arap]})

    def compare(self, side, ref):
        """The shared numbers, and the ARAP energy (its rotation fit on the
        program's ``csrc/rotfit.cu``) of each first step."""
        r = super().compare(side, ref)
        r["arap"] = max(abs(a - b) / abs(b) for a, b in zip(side["carry"]["arap"], ref["carry"]["arap"]))
        return r

    def reference_lrs(self, it):
        return RN.phase_b_lrs(self.cfg, it)

    def reference_deform(self, params, f):
        gs = params["gs"]
        return RN.warp_forward(params["warp"], gs["xyz"], f["fid"], gs["feature"],
                               torch.sigmoid(gs["feature"][:, -1:]), self.cfg["nodes"])

    def model_flops(self, n_points):
        return roofline.node_flops(self.cfg, n_points)
