"""Stage-2 training steps of the skeleton model (``train/stage2.py``
``make_stage2_auto``) at the schedule's steady tail, as ``training.py``
drives them; the check's reference is ``reference/train.py``."""
from __future__ import annotations

import torch

from portbench import program, roofline, scene, training
from portbench.reference import model as RM
from portbench.reference import train as RT


class Driver(training.TrainDriver):
    model_key = "skel"
    DEFORM_NUMBERS = (("d_xyz", "deform"), ("d_nodes", "joints"), ("template_offsets", "offsets"))

    def build(self):
        from riggs_tpu_torch.models import skeleton_warp as SW
        from riggs_tpu_torch.models.gaussians import init_densify_stats
        from riggs_tpu_torch.train import stage2 as S2
        from riggs_tpu_torch.train.optim import adam_init

        cfg, dev = self.cfg, self.dev
        self.weights = scene.make_skeleton_weights(cfg, self.seed, self.avatar["joints"], dev)
        gs = program.gaussians(self.avatar, cfg["avatar"]["sh_degree"])
        skel = program.skeleton(self.avatar["joints"], self.weights, cfg, dev)
        F, C, J = len(self.pframes), gs.capacity, len(scene.PARENTS)
        # the distillation targets weigh 0 past the warm-up
        self.program_extra = (torch.zeros((1, C, 3), device=dev).expand(F, C, 3),
                              torch.zeros((1, J, 3), device=dev).expand(F, J, 3))
        self.state = S2.Stage2State(gs=gs, skel=skel, opt_gs=adam_init(gs.params_dict()),
                                    opt_skel=adam_init(skel.params_dict()), stats_gs=init_densify_stats(C, device=dev),
                                    proj_loss=torch.full((F,), 1.0e5, device=dev),
                                    it=torch.tensor(self.traffic["start_it"], dtype=torch.int32, device=dev))
        self.step_fn = S2.make_stage2_auto(self.pcfg, template_idx=0)
        self.capture = program.Capture({"deform": (SW, "deform_by_pose", program.DEFORM_KEYS),
                                        "render": (S2, "render", program.RENDER_KEYS)})

    def call_step(self, frame, uid):
        self.state, m = self.step_fn(self.state, frame, uid, self.bg, *self.program_extra, it=self.it,
                                     use_chamfer=True, lambda_dssim=self.pcfg.opt.lambda_dssim,
                                     max_per_tile=self.pcfg.pipe.max_per_tile, isotropic=False,
                                     tile_ladder=self.ladder)
        return m

    def probe(self, frame):
        from riggs_tpu_torch.models import skeleton_warp as SW
        from riggs_tpu_torch.render.api import render, tier_kwargs

        gs, skel = self.state.gs, self.state.skel
        d = SW.skeleton_forward(skel, gs.xyz, frame.fid, gs.motion_mask)
        return render(frame.cam, gs, self.bg, d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                      d_scaling=torch.zeros_like(d["d_scaling"]), active_sh_degree=gs.max_sh_degree,
                      max_per_tile=self.pcfg.pipe.max_per_tile, **tier_kwargs(self.tiers))

    def params(self):
        return {"gs": self.state.gs.params_dict(), "skel": self.state.skel.params_dict()}

    def moments(self):
        return {"gs": self.state.opt_gs.mu, "skel": self.state.opt_skel.mu}

    def reference_loss(self, params, k, uid, carry):
        proj_loss = carry.get("proj_loss", torch.full((len(self.frames.fid),), 1.0e5, device=self.dev))
        loss, ren, d, cd = RT.frame_loss(params["gs"], params["skel"], self.avatar["alive"], self.avatar["joints"],
                                         scene.PARENTS, self.ref_frame(uid), uid, proj_loss, self.cfg)
        proj_loss = proj_loss.clone()
        proj_loss[uid] = cd.detach()
        return loss, ren, d, {"proj_loss": proj_loss}

    def reference_lrs(self, it):
        gs_lr, skel_lr = RT.step_lrs(self.cfg, it)
        return {"gs": gs_lr, "skel": skel_lr}

    def reference_deform(self, params, f):
        rot, trans = RM.pose_at(params["skel"], f["fid"], self.cfg["skeleton"])
        mm = torch.sigmoid(params["gs"]["feature"][:, -1:])
        return RM.deform(params["skel"], self.avatar["joints"], scene.PARENTS, params["gs"]["xyz"], rot, trans, mm,
                         self.cfg["skeleton"])

    def model_flops(self, n_points):
        return roofline.skeleton_flops(self.cfg, n_points, len(scene.PARENTS))
