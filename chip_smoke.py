#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printed as it runs:
  1. device: the card's name and power limit (nvidia-smi), CUDA, nvcc;
  2. build: the blend and rotation-fit kernels from riggs_tpu_torch/csrc/
     with nvcc (sm_90a), one nvcc per source, started together;
  3. kernels: each forward kernel against its plain PyTorch version on the
     windows the full-width scene really bins (plain windows and every
     ladder bucket): tentry bitwise equal (so the same active (tile, chunk)
     pairs), out within KERNEL_TOL, a second launch bitwise equal; CUDA-event
     times (plain, kernel, kernel, plain) per frame beside the bound, and
     each call's own time with the device time of each of its launches; then
     the tiled renderer against the exact oracle on a small scene; then
     edges: on seeded synthetic windows (a tile of 64 chunks, counts ending
     mid-chunk, an empty tile, a tile saturating in chunk 3 of 10, a faint
     tile live past half its chunks) each forward kernel held as above, then
     each backward kernel against its plain version on the forward kernel's
     tentry (exact zeros where due, a second launch bitwise equal), and no
     launch for T == 0 or C == 0, forward or backward; then the offset
     entry (pallas_blend_offset's) on the serving frame's real windows:
     tiles [k, k + n) blended with tile_offset k, for k = 0, 150 (a
     multiple of tiles_x) and 313 (the second half of a 2-way split), out,
     tentry and dg bitwise equal to rows k..k+n-1 of the full call, each
     held to its plain version, and timed on the 313 shard;
  4. slice: the rigged avatar at full stage-2 width (131072-slot capacity,
     100000 alive Gaussians, SH degree 3, motion mask, a seeded 24-joint
     tree, three 8x256 MLPs, dense skinning, 800x800): eval_image at several
     times, one random-motion pose, the ladder probe and fit, the laddered
     renders, with the kernels' launch counters zeroed just before and read
     just after; the forward kernels held to their plain versions on the
     random-motion pose's windows and a laddered frame's; then ladder vs
     plain windows and kernel vs plain-version renders, and per-frame times
     of both paths;
  5. profile: for each path, the host-clock split between skeleton_forward
     and render, the device's busy time by kernel (torch.profiler) and its
     idle share;
  6. train: the stage-2 training step (make_stage2_auto) on the same avatar
     at full width against a target rendered with a second seeded skeleton:
     steps at it = 0 (warmup) and it = 15001 (template offsets, skinning
     MLP, chamfer, SH 3) on plain windows and on the ladder, with the launch
     counters zeroed just before and read just after; the frame loss's
     gradient of every parameter group, finite and nonzero where the flags
     give one, kernel path against plain-version path; each forward and
     backward kernel against its plain version on the inputs it got in a
     real step (and a second launch bitwise equal), with its time beside its
     bound, and each call's own time (the ladder's buckets one by one); the
     step time, its three parts (the ranges
     stage2_step names for the profiler), and the device's busy time and
     idle share per step;
  7. runs: the same avatar through render_auto(binning="runs") and the
     gradient of a photometric loss through the aligned-runs path, with the
     counters zeroed just before and read just after; the frame against the
     plain-window frame, the gradient per group against the plain-window
     gradient, each runs kernel against its plain version on the frame's
     real g_runs, and the runs frame and gradient timed against the
     plain-window ones;
  8. stage1: init_stage1 from the avatar's canonical points (131072-slot
     capacity, 512 nodes, hyper_dim 8, the 8x256 blender DeformNetwork, SH 3,
     the motion mask; the log-scales jittered) and make_phase_b_auto steps
     at it = 0 (warm-up) and 5000 (chamfer and the motion-mask loss on) on
     plain windows and on a fitted ladder, with the counters zeroed just
     before and read just after; gradients finite and nonzero where the
     flags give one, kernel path against plain-version path; each forward
     and backward kernel against its plain version on a real step's inputs,
     with each call's time, and the fused rotation-fit kernel
     (estimate_rotations) on the step's ARAP fits (max |d R| on the
     well-posed fits, det R on every fit, the ill-posed ones counted, the
     Jacobi sweeps counted by its debug build, the covariance entry held
     on the same edges; a call's time and its device time a launch back to
     back beside an empty kernel's, the plain version's, the stock chain's
     with torch.linalg.svd and the chain it replaced), then on
     planted fits and planted edge sets against the choices csrc/rotfit.cu
     documents; step time (a replayed CUDA graph), busy time and idle
     share; the node warp timed alone;
  9. sync: each auto step (make_stage2_auto and make_phase_b_auto on both
     window paths, make_phase_a_auto) and the serving frame's render, one
     call each under torch.cuda.set_sync_debug_mode("error") (any
     synchronizing operation raises) with its device-to-host copies and
     stream synchronizations counted by the profiler: zero each (the
     stage-1 steps' rotation fit is a kernel that reads nothing back);
     eval_image in "warn" mode, its two overflow reads by design and no
     other;
  10. stage1 phase A: init_stage1 as in 8 (8192 node-Gaussian slots, 512
     nodes, SH 0, a shared isotropic scale) on the [loop] scene's first
     frame, make_phase_a_auto at it = 0 (d_xyz detached, chamfer and
     regularizers off) and 7501 (both on) with the counters zeroed just
     before and read just after; gradients finite and nonzero exactly where
     the toggles give one, kernel path against plain-version path; blend_cm
     and blend_cm_bwd against their plain versions on the node cloud's
     windows with each call's time and bound, the rotation fit on the
     step's covariances; no overflow;
  11. loop: train_stage1 on a full-width scene (8 frames of the avatar from
     an arc of cameras at 800x800 on white, alpha masks from the render's
     acc, thinned skeletons, cameras_extent from compute_scene_extent),
     only the schedule cut (LOOP_SCHEDULE): its events, node counts, ladder
     refits, loss and PSNR at both ends of both phases, ms per step of each
     phase and the device's busy time and idle share over 5 steps of each;
     every parameter finite, no step overflowed but where the ladder
     reacted one step late, every kernel of the path launched; then the
     four kernels held to their plain versions, as in 3 and 6, and the
     rotation fit as in 8, on the inputs of three of the loop's own steps
     (LOOP_HELD: phase A on the densified node cloud and phase B's first
     probe step at the loop's plain window, its last step on the refitted
     ladder);
  12. pipeline: from the loop's trained state, init_stage2 (the loop's
     frames through the trained node warp, skeleton extraction from up to
     200 of its nodes, the template bake, three 8x256 MLPs on the ~103k
     alive Gaussians of 131072 slots) and train_stage2 with only the
     schedule cut (STAGE2_SCHEDULE): the skeleton, the bake and the
     extraction's host time; the events (the FPS reset, densification, the
     ladder fit and refits, the test evaluation on two test frames between
     the train frames); loss and PSNR at both ends of the warm-up and the
     main phase; ms per step of each and busy time and idle share over 5
     steps of each; the host reads of one step with no event (exactly the
     one late copy of the overflow counters); every parameter finite, every
     kernel of the path launched; the four kernels held to their plain
     versions on three of its steps (PIPE_HELD);
  13. io: the pipeline's rig saved (state .npz, PLY, skeleton tree, OBJ,
     cfg.json) and loaded back into a fresh init_stage2 template, every leaf
     bitwise, and the PLY's alive Gaussians bitwise, with the seconds and
     the file sizes; train_stage2 resumed from the checkpoint for
     IO_RESUME_STEPS steps with a recording logger (it starts at the saved
     iteration, one test evaluation and one best-PSNR checkpoint, the
     newest); render_test_set on the two test frames with the skinning
     render and LPIPS alex and vgg from seeded files of
     scripts/make_lpips_ckpt.py, the card's LPIPS held to the CPU's on the
     same images (LPIPS_REL_TOL), the per-frame overflow counters, host
     reads and ms a frame with and without the skinning render, with the
     counters zeroed just before the resume and read after the test set;
     then the forward blend calls of one test frame and its skinning render
     held to their plain versions, as in 3;
  14. flow: train_stage1 on the [loop] scene with flow files of the
     avatar's own motion to each frame's neighbours (raft_neighbouring/,
     raft_masks/), the flow term from phase B's step 10 (FLOW_WARM_UP), the
     counters zeroed just before and read just after: the partners drawn,
     the flow term, ms per flow step beside [loop]'s phase B, busy time and
     idle share, the flow render's overflow; blend_cm and blend_cm_bwd held
     to their plain versions on a flow step's own flow render (signed
     colours), with the ladder's kernels and the rotation fit of that step
     (FLOW_HELD); a flow step under the sync audit;
  15. zju: a one-subject ZJU-MoCap root written from the avatar (12 frames
     at 1024 x 1024, off-centre principal points, distortion, a seeded SMPL
     global transform, 6890 SMPL-prior points a frame, points3d.ply,
     thinned skeletons, two test views), read by load_scene on the card;
     train_stage1 at scripts/run_zju.py's widths and capacity 65536 (ROADMAP
     C5), the counters zeroed just before and read just after: ms per
     reference-point and phase-B step, busy time and idle share, the
     reference loss, densification past 6890 alive; the four kernels and
     the rotation fit held on ZJU_HELD; a reference-point step under the
     sync audit; scripts/torch_run_zju.py as a process of its own: exit 0,
     every file of scripts/run_zju.py's chain, J, the test metrics;
  16. cli: scripts/torch_run_pipeline.py --synthetic as a process of its
     own on the card (CLI_RUN_SCHEDULE cuts only the schedule) with
     --viewer_port, --gui_port and --detect_anomaly: while it trains, its
     live viewer answers a /render and its SIBR endpoint a request from
     this process; exit 0, every
     file scripts/run_pipeline.py writes, a finite numerical_res.txt, and
     its rig/ reloaded as scripts/torch_render_rig.py loads it, reproducing
     that table; then scripts/torch_resume_stage2.py on its stage-1
     checkpoint (its node set densified and pruned) as a process of its
     own, stage 2 resumed to RESUME_ITERATIONS, its rig reloaded;
  17. refpoint: scripts/torch_run_refpoint.py as a process of its own at
     its full width (800x800, 131072 slots, 512 nodes, the biped scene),
     only the schedule cut (REFPOINT_ARGS), then with --resume: exit 0,
     the reference's report keys, finite ms per step, J >= 2, the stage-1
     state and the stage-2 checkpoint read back, its kernel launches;
  18. binners: the serving avatar through render(binning="compact") and
     "sort2", forward and a loss's gradient, the counters zeroed just
     before and read just after: frames against the sort binner's
     (PATH_TOL), gradients per column (BWD_TOL), blend_cm and its backward
     held on each binner's windows, each structural gather backward held to
     autograd's index backward on the render's own dg; render_auto's
     compact escalation from a quarter of the instances; frame ms and busy
     time of each binner against sort's;
  19. static: train_static on the [loop] scene (131072 slots, SH 3, 40
     steps, one densification and one opacity reset), the counters zeroed
     just before and read just after: loss, ms per step, busy time, the two
     kernels held on one step, a train_step under the sync audit;
  20. mlpdeform: train_mlp_deform on the same scene (the 8x256
     DeformNetwork at every slot, warm-up 10, one densification): the
     MLP's weights and Adam state bitwise unchanged through the warm-up and
     changed after, ms per step, busy time, the kernels held on one step,
     a step under the sync audit;
  21. hash: apply_hash_deform at the default grid over 131072 points,
     forward and backward, card against CPU (HASH_TOL); arap_loss_with_rot
     on the [loop]'s 512-node warp with and without the rotation term, card
     against CPU (ARAP_ROT_TOL), the rotation-fit kernel launched;
  22. tileshard: two processes on the card over gloo (NCCL takes one rank
     per device), each building the avatar and the [train] frame from the
     seeds: rasterize_tile_sharded on a 1 x 2 mesh against rasterize_tiled
     (frame and gradients bitwise); 5 make_dp_stage2_step steps at 1 x 2
     (tile-parallel; the counters zeroed just before and read just after:
     the offset entry's two kernels, no plain blend) against 5
     stage2_steps; 5 steps at 2 x 1 (B = 2); 20 iterations of
     train_stage2_dp at 1 x 2 (an FPS reset, a densification, a test
     evaluation, rank 0's checkpoint); every state hashed equal on both
     ranks; ms per step beside the single-device step; then one NCCL rank
     in this process on a 1 x 1 mesh, bitwise against one device;
  23. dp1: two processes on the card over gloo, each building [stage1]'s
     initial state from the seeds: 5 make_dp_stage1_step steps at 2 x 1
     (B = 2, it = 5000; the counters zeroed just before and read just
     after: the blend kernels and one estimate_rotations a frame) and 5
     make_dp_static_step steps; 28 iterations of train_stage1_dp at 2 x 1
     with the ladder (a node densify/prune, a Gaussian densification, an
     opacity reset, the ladder fit); every state hashed equal on both
     ranks; then one NCCL rank in this process on a 1 x 1 mesh: the same
     steps of B = 2 on one rank, the 2 x 1 states held to them (1e-6 of a
     leaf's max), a dp step under the sync audit (no host read) and the
     loop's reads counted (one a step by design).
  24. multihost: two processes on the card join through
     parallel/multihost.py's init_distributed from torchrun's environment
     (gloo: two ranks on one card) and build make_host_mesh (2 x 1); each
     feeds MH_STEPS full-width dp stage-2 steps through host_local_frames +
     global_batch and through the whole stack (shard_batch): states bitwise
     equal both ways and on both ranks; the ranks save the state with the
     sharded checkpoint pair and this process loads it, every leaf bitwise;
     then scripts/torch_multihost_smoke.py (static and --stage2, two
     processes each), scripts/torch_scaling_bench.py --ranks 2 and
     scripts/torch_run_pipeline.py --synthetic --dp 2 (MH_CLI_SCHEDULE; its
     files from rank 0 only, its rig reloaded) as processes of their own,
     after the ranks (whose steps, save and load run alone on the card)
     and side by side;
  25. anim: from [stage1]'s initial state, warp_forward_animated with a
     seeded drag of some nodes and the frame rendered with its d_xyz,
     d_rotation and d_rotation_bias, the counters zeroed just before and
     read just after: fit_rotations (p2dR's fit) launched and held to its
     plain version; geodesic_floyd card against CPU (the same graph, its
     closure bitwise, the whole call within a bound derived from the
     edges' differences and the paths' hop counts); the frame finite, a
     second call bitwise equal; then interpolate_key_poses driving
     render_rigged between two seeded poses.
  26. edit: the ARAP editor on the serving avatar in a ViewerServer:
     EditSession's 256 FPS controls, a seeded control picked at its pixel
     and dragged by a seeded delta, the edited frame, optimize_weights once,
     the counters zeroed just before and read just after: fit_rotations 3
     times a solve, estimate_rotations, each launch held to its plain
     version; deform_arap card vs the port on the CPU (EDIT_TOL of the
     extent), the handles on their targets, a second drag from a cleared
     session bitwise equal; a drag's ms and its frame's.
  27. viewer: ViewerServer on the serving avatar on an ephemeral localhost
     port, every endpoint (render modes, edit, pose library, playback) 200,
     every frame's overflow headers 0: the reference's window of 512
     truncates the avatar (its counters printed), and the viewer renders
     such a frame again on its tile ladder (blend_cm, then
     blend_permuted_gm); the viewer frame within PATH_TOL of a plain window
     that holds it; the rgb PNG equal to render_frame's frame quantized;
     its ms beside the truncated frame's; a SIBR round trip;
     scripts/torch_viewer.py as a process on a rig written from the avatar;
     scripts/torch_test_speed.py on that rig, its plain window grown and
     --ladder, its FPS line beside [slice]'s serving frame, its timed
     frames' overflow 0.
  28. bench: scripts/torch_bench.py (bench.py's twin) as a process of its
     own at its defaults (100 000 Gaussians at 800x800, the tiers and the
     ladder), --no-ladder and --no-tiers: each run's last line bench.py's
     four-key JSON line, its overflow assert held, the kernels it launched
     over its timed steps non-zero; then each setting's gradient step in
     this process, its forward and backward kernels held to their plain
     versions on the twin's own windows and cotangents.
Then a ``{"kernels": [...]}`` line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero. Without CUDA
it exits 2 and prints no result. Imports nothing of JAX or riggs_tpu.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

# SMPL-style 24-joint tree (root's parent is itself) and rest joints in metres
PARENTS = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)
REST_JOINTS = np.array([
    [0.00, 0.00, 0.00], [0.06, -0.09, 0.00], [-0.06, -0.09, 0.00], [0.00, 0.11, 0.00],
    [0.10, -0.47, 0.00], [-0.10, -0.47, 0.00], [0.00, 0.25, 0.00], [0.09, -0.87, -0.04],
    [-0.09, -0.87, -0.04], [0.00, 0.30, 0.02], [0.11, -0.93, 0.08], [-0.11, -0.93, 0.08],
    [0.00, 0.51, -0.01], [0.08, 0.42, 0.00], [-0.08, 0.42, 0.00], [0.00, 0.62, 0.04],
    [0.19, 0.45, -0.01], [-0.19, 0.45, -0.01], [0.45, 0.43, -0.03], [-0.45, 0.43, -0.03],
    [0.71, 0.44, -0.03], [-0.71, 0.44, -0.03], [0.79, 0.43, -0.04], [-0.79, 0.43, -0.04],
], np.float32)

CAPACITY, N_ALIVE, SIZE, SH_DEGREE = 131072, 100000, 800, 3
DEVICE = "cuda"
FRAME_TIMES = (0.0, 0.3, 0.6, 0.9)
PROBE_TIMES = tuple(i / 8 for i in range(8)) + FRAME_TIMES
# forward kernel vs plain version on the card: same expf/log1pf and
# operation order, sums in another order (per-pixel running sums vs a
# batched matmul); tentry must be bitwise equal (the backward reads it)
KERNEL_TOL = {"rgb_acc": 2e-5, "depth": 2e-4}
# ladder vs plain windows, and kernel path vs plain-version path (the
# reference's own bounds, tests/test_pallas_blend.py:88-91)
PATH_TOL = {"image": 2e-5, "alpha": 2e-5, "depth": 2e-4}
# the card's rates for the bound (NVIDIA H100 SXM: 132 SMs at 1.98 GHz).
# HBM: the data sheet's 3.35 TB/s. FP32 instructions: 128 lanes per SM, one
# instruction each per clock, 33.5e12/s; the data sheet's 67 TFLOP/s counts
# an FMA as two. The counts below are instructions: a product and sum that
# the kernel leaves to FMA contraction (the accumulations) count as one, a
# product or sum that it rounds on its own (__fmul_rn / __fadd_rn: the EWA
# power, alpha, transmittance and the values the thresholds or the
# backward's two sweeps compare) as one each. exp and log1p: the
# special-function unit, 16 per clock per SM, 4.18e12/s.
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 33.5e12
SFU_OPS_PER_S = 4.18e12
# FP32 and SFU operations of the blend: every (Gaussian, pixel) pair of an
# active chunk needs the EWA power and the alpha test (2 sub, 9 rounded
# mul/add, exp, 4 compare/min); a pair whose alpha reaches 1/255 also needs
# the transmittance update and the accumulation (log1p, add, exp, mul,
# compare, sub, div, mul: 8; four FMAs into rgb and depth and one add into
# the weight sum: 5). The SFU counts are the exp and log1p among them.
OPS_PER_PAIR = 16
OPS_PER_HIT = 13
SFU_PER_PAIR = 1
SFU_PER_HIT = 2
# the same count for the backward, as the function needs it (csrc/blend.cu
# blend_bwd recomputes the power, alpha and transmittance in a second sweep;
# that is the design's cost, not the function's): every live pair needs the
# EWA power and the alpha test once (16); a pair whose alpha reaches 1/255
# also needs the transmittance update and weights (log1p, add, exp, mul,
# compare, sub, div, 2 mul: 9), the rounded value dot [rgb, depth, 1] . dC
# (8), the rounded running sum of w * vdc (2), the suffix (2), dalpha (3),
# dpower (compare, mul: 2), and its ten sums over the tile's pixels (12):
# dx * dpower and dy * dpower (2 mul), their sums and dpower's (3 add), the
# three second moments (3 FMA) and w * dC[0:4] (4 FMA). The per-row assembly
# of dg is per row, not per pair, and not counted.
OPS_PER_PAIR_BWD = OPS_PER_PAIR
OPS_PER_HIT_BWD = 38
SFU_PER_PAIR_BWD = SFU_PER_PAIR
SFU_PER_HIT_BWD = 2  # log1p, exp
# backward kernel vs plain version, and the step's gradient on the kernel
# path vs the plain-version path: per column (attribute, or parameter leaf)
# max |delta| <= 1e-3 * max |plain|
BWD_TOL = 1e-3
TRAIN_ITS = (0, 15001)  # warmup; everything unlocked (optimize_template_offsets_iters 15000)
TRAIN_STEPS = 2  # counted steps per (it, path)
UID, N_FRAMES, N_THIN = 0, 4, 256  # the template frame; pre_d_* frames; padded thinned points
RUNS_T = 0.3  # the [runs] frame's time
STAGE1_ITS = (0, 5000)  # warm-up; past warm_up with the ARAP and motion-mask lambdas on
STAGE1_STEPS = 2  # counted steps per (it, path)
PHASE_A_ITS = (0, 7501)  # the node warm-up (d_xyz detached, no regularizers); the chamfer and regularizers on
LOOP_FRAMES = 8  # the [loop] scene's train frames
LOOP_ARC_DEG = 30.0  # its cameras on an arc of +-30 degrees about the front view (side views pile up the arms)
# the [loop] schedule: only these are cut from the defaults (PERF.md section 4)
LOOP_SCHEDULE = dict(iterations_node_rendering=40, node_warm_up=10, densification_interval=10,
                     iterations_node_sampling=30, iterations=40, densify_from_iter=5,
                     node_force_densify_prune_step=20, opacity_reset_interval=30, ladder_check_every=10)
LOOP_TEST_BETWEEN = (2, 5)  # the two test frames lie halfway after these train frames
PROFILE_FROM = 20  # the loop's profiled steps of each phase: [20, 25)
# the loop's steps whose blend calls are held to the plain versions: phase A
# on the densified node cloud, phase B's first probe step (plain windows) and
# its last (the ladder as the loop fitted and refitted it)
LOOP_HELD = {("A", 25): "phase A it=25", ("B", 0): "phase B probe it=0", ("B", 39): "phase B ladder it=39"}
# the [pipeline] schedule of train_stage2: only these are cut from the
# defaults (PERF.md section 4); densification at 30, 40 and 50, the FPS
# reset and the template offsets' unlock at 40, a test evaluation at 30
STAGE2_SCHEDULE = dict(iterations_stage2=60, skeleton_warm_up=20, optimize_template_offsets_iters=40,
                       gs_densification_iterations=25, densify_from_iter=25, densify_until_iter=55,
                       densification_interval=10, ladder_check_every=10)
PIPE_TEST_EVERY = 30
# its profiled steps: the warm-up's [14, 19) and the main phase's [45, 50);
# the step whose host reads are counted (no event: the ladder fitted at 11,
# no check, densification, reset, log or test due)
PIPE_PROFILE_FROM = {"W": 14, "M": 45}
PIPE_SYNC_STEP = 34
# the steps whose blend calls are held to the plain versions: a warm-up
# probe step (plain windows), the step after the FPS reset and the last
# (both on the ladder)
PIPE_HELD = {("W", 5): "warm-up probe it=5", ("M", 40): "after the FPS reset it=40", ("M", 59): "ladder it=59"}
# [io]: the pipeline's rig resumed from its checkpoint at 60 for 16 steps
# (the ladder refits after its 12 probe steps, the last 4 run on it), one
# test evaluation and one best-PSNR checkpoint at 70, the logger every 5
IO_RESUME_STEPS = 16
IO_TEST_AT = 70
IO_LOG_EVERY = 5
LPIPS_REL_TOL = 1e-4  # the card's LPIPS against the CPU's on the same images: TF32 off
# [cli]: scripts/torch_run_pipeline.py --synthetic (16 frames at 128 x 128,
# the default widths: 65536 slots, 512 nodes, three 8x256 MLPs), only the
# schedule cut (PERF.md section 4); stage 2 runs `iterations` steps too
CLI_SCHEDULE = dict(iterations_node_rendering=40, node_warm_up=10, iterations_node_sampling=30, iterations=40,
                    densify_from_iter=5, densification_interval=10, node_force_densify_prune_step=20,
                    opacity_reset_interval=30, ladder_check_every=10, skeleton_warm_up=10,
                    optimize_template_offsets_iters=20, gs_densification_iterations=15, densify_until_iter=35)
CLI_TEST_EVERY = 30
# [cli]'s own run carries --viewer_port, --gui_port and --detect_anomaly;
# anomaly mode (a trace and a NaN check for every op) makes its steps ~3x
# as long, so it runs CLI_SCHEDULE at half depth, every count and interval
# halved, so every event still fires (PERF.md section 4), with a test
# evaluation every CLI_RUN_TEST_EVERY
CLI_RUN_SCHEDULE = {k: v // 2 for k, v in CLI_SCHEDULE.items()}
CLI_RUN_TEST_EVERY = 10
# the resume twin on [cli]'s output: stage 2 resumed from its checkpoint at
# CLI_RUN_SCHEDULE's 20 to RESUME_ITERATIONS
RESUME_ITERATIONS = 25
# [flow]: [loop]'s scene and schedule with warm_up 3000 -> 10, so that
# phase B's steps 10-39 carry the flow term (after the opacity reset at 30
# few pixels stay solid, alpha > 0.9, and the term may fall to 0); the held
# step is on the ladder before the reset, so its blend_cm calls are the flow
# render's alone, with a live gradient
FLOW_WARM_UP = 10
FLOW_HELD = {("B", 25): "flow step it=25"}
# [zju]: a one-subject data root written from the avatar at ZJU-MoCap's
# 1024 x 1024, ZJU_FRAMES train frames (a cut from a subject's hundreds),
# two test views of one frame each ((camera id, frame)), SMPL's 6890 points
ZJU_FRAMES, ZJU_SIZE, ZJU_M = 12, 1024, 6890
ZJU_TEST_VIEWS = ((2, 2), (3, 7))
# its train_stage1: only the schedule cut, as [loop]'s (40 reference-point
# steps, 40 phase-B steps); held: the probe step (plain windows) and the
# last (the ladder)
ZJU_SCHEDULE = LOOP_SCHEDULE
ZJU_HELD = {("B", 0): "zju probe it=0", ("B", 39): "zju ladder it=39"}
# scripts/torch_run_zju.py's --extra cuts: [cli]'s schedule
ZJU_CLI_SCHEDULE = CLI_SCHEDULE


# the rotation fit (csrc/rotfit.cu) against its plain version: max |d R|
# on the well-posed fits and |det R - 1| on every fit; a fit is ill-posed
# where min(s1 + s2, s1 + d s3, s2 + d s3) < ILL_POSED * s1
ROTFIT_TOL = 1e-5
ILL_POSED = 1e-2
# its bounds: the function's bytes over HBM (the kernels' f64 Jacobi
# sweeps are their design, not the function's work): the fused entry reads
# a node's two rows, its K indices, weights and flags and writes R, the
# covariance entry a 3x3 f32 matrix in and one out
ROTFIT_COV_BYTES = 72
ROTFIT_SWEEPS = 8  # csrc/rotfit.cu's cap


def _rotfit_bytes(n, K):
    return n * (24 + 9 * K) + 36 * n


def _bound(nbytes, ops, sfu):
    """The least time the card could take for the work: the largest of the
    bytes over the HBM rate, the FP32 instructions over their issue rate and
    the exp / log1p over the SFU rate. The kernels line's schema allows
    only "bytes" or "operations" in ``bound_by``, so ``bound_term`` names
    which of the two operation terms it is."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "fp32 instructions": ops / FP32_INSTR_PER_S * 1e3,
             "sfu operations": sfu / SFU_OPS_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term], "bound_by": "bytes" if term == "bytes" else "operations", "bound_term": term}


def build_avatar(seed: int, n_alive: int, capacity: int, size: int, device: str):
    """The seeded full-width avatar: Gaussians along the bones of the 24-joint
    tree, a SkeletonWarp with random 8x256 MLPs, and an 800x800 camera."""
    import torch

    from riggs_tpu_torch.camera import make_camera
    from riggs_tpu_torch.convert import gaussians_from_numpy
    from riggs_tpu_torch.models.skeleton_warp import init_skeleton_warp
    from riggs_tpu_torch.ops.sh import rgb_to_sh_dc, sh_dim

    rng = np.random.default_rng(seed)
    joints = REST_JOINTS + rng.normal(scale=0.01, size=REST_JOINTS.shape).astype(np.float32)
    parents = np.array(PARENTS)
    bones = np.arange(1, len(PARENTS))
    length = np.linalg.norm(joints[bones] - joints[parents[bones]], axis=1)
    b = rng.choice(bones, size=n_alive, p=length / length.sum())
    u = rng.uniform(size=(n_alive, 1))
    xyz = joints[parents[b]] + u * (joints[b] - joints[parents[b]])
    xyz += rng.normal(scale=0.05, size=xyz.shape)

    def pad(a, fill=0.0):
        out = np.full((capacity,) + a.shape[1:], fill, np.float32)
        out[:n_alive] = a
        return out

    rot = np.zeros((capacity, 4), np.float32)
    rot[:, 0] = 1.0
    rot[:n_alive] = rng.normal(size=(n_alive, 4))
    params = {
        "xyz": pad(xyz),
        "f_dc": pad(rgb_to_sh_dc(rng.uniform(0.1, 0.9, size=(n_alive, 1, 3)))),
        "f_rest": pad(rng.normal(scale=0.05, size=(n_alive, sh_dim(SH_DEGREE) - 1, 3))),
        "scaling": pad(np.log(rng.uniform(0.004, 0.012, size=(n_alive, 3)))),
        "rotation": rot,
        "opacity": pad(rng.normal(1.0, 1.0, size=(n_alive, 1))),
        "feature": pad(rng.normal(2.0, 1.0, size=(n_alive, 1))),
    }
    alive = np.arange(capacity) < n_alive
    gs = gaussians_from_numpy(params, alive, SH_DEGREE, isotropic=False, with_motion_mask=True, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    skel = init_skeleton_warp(joints, PARENTS, K=-1, use_skinning_mlp=True,
                              use_template_offsets=True, generator=gen, device=device)
    R = np.diag([1.0, -1.0, -1.0])  # camera-to-world: look along -z, image y down
    cam = make_camera(R, np.array([0.0, 0.15, 2.6]), size, size, fovx=0.8, fovy=0.8, device=device)
    bg = torch.zeros(3, device=device)
    return gs, skel, cam, bg


def frame(gs, skel, cam, bg, t=None, pose=None, **kw):
    """One serving frame through the port's entry points: skeleton_forward
    (or deform_by_pose for an explicit pose), then render."""
    import torch

    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.render.api import render

    with torch.no_grad():
        if pose is None:
            d = SW.skeleton_forward(skel, gs.xyz, t, gs.motion_mask)
        else:
            d = SW.deform_by_pose(skel, gs.xyz, pose["local_rotation"], pose["global_trans"], gs.motion_mask)
        return render(cam, gs, bg, d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                      d_scaling=torch.zeros_like(d["d_scaling"]),
                      active_sh_degree=gs.max_sh_degree, **kw)


class _Capture:
    """Record the arguments of the blend wrappers ``names`` (the forward
    entries, or the backward wrappers the autograd Function calls) while a
    frame renders or a step runs."""

    def __init__(self, blend, names=("blend_cm", "blend_permuted_gm")):
        self.blend = blend
        self.calls = {k: [] for k in names}

    def __enter__(self):
        self.orig = {k: getattr(self.blend, k) for k in self.calls}
        for k, fn in self.orig.items():
            def rec(*args, _k=k, _fn=fn):
                self.calls[_k].append(args)
                return _fn(*args)
            setattr(self.blend, k, rec)
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.blend, k, fn)


class _PlainBlend:
    """Route the renderer's blends, forward and backward, to the plain
    PyTorch versions (on CUDA tensors too) for the kernel-path vs plain-path
    comparison."""

    def __init__(self, blend):
        self.blend = blend

    def __enter__(self):
        b = self.blend
        self.orig = (b.blend_cm, b.blend_permuted_gm, b.blend_runs)
        b.blend_cm = lambda g, counts, tx: b.BlendFn.apply(g, b.blend_cm_plain, b.blend_cm_bwd_plain, tx, counts)
        b.blend_permuted_gm = lambda g, counts, tids, tx: b.BlendFn.apply(
            g, b.blend_permuted_gm_plain, b.blend_permuted_gm_bwd_plain, tx, counts, tids)
        b.blend_runs = lambda g, counts, sblk, chunks, tx: b.BlendFn.apply(
            g, lambda g_, c_, s_, tx_: b.blend_runs_plain(g_, c_, s_, chunks, tx_), b.blend_runs_bwd_plain,
            tx, counts, sblk)
        return self

    def __exit__(self, *exc):
        self.blend.blend_cm, self.blend.blend_permuted_gm, self.blend.blend_runs = self.orig


def _event_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _active(tentry, counts):
    """(T, C) active (tile, chunk) pairs: the chunk starts before the tile's
    count and some pixel enters it with T >= 1e-4."""
    import torch

    c = torch.arange(tentry.shape[1], device=tentry.device)
    return (c[None, :] * 128 < counts.to(torch.int64)[:, None]) & (tentry.amax(dim=2) >= 1e-4)


def _work(name, calls, outs, offset=0):
    """Bytes and operations the blend calls of one frame need on this data.
    Pairs are the (Gaussian, pixel) pairs of active chunks (the chunk starts
    before the tile's count and some pixel enters it with T >= 1e-4), rows
    before the count; hits are the pairs whose alpha reaches 1/255 (local
    tile t of blend_cm is tile t + ``offset``). The g
    rows of active chunks are read once, counts (and tids) read once, the
    five used rows of out written once, and tentry written for the chunks
    that start before the count (the only ones the backward reads). Also
    the started and active chunks, and the kernels' scratch bytes."""
    import torch

    from riggs_tpu_torch.render import blend as B

    pairs = hits = nbytes = started = active = scratch = 0
    for args, (out, tentry) in zip(calls, outs):
        g, counts, tiles_x = args[0], args[1].to(torch.int64), args[-1]
        if name == "blend_cm":
            g = g[:, :10].transpose(1, 2)  # (T, MAX, 10) view
            tids = torch.arange(g.shape[0], device=g.device) + offset
        elif name == "blend_runs":  # the (T, chunks * 128, 10) windows of the blocks read
            g = B._runs_windows(g, B.runs_blocks(args[1], args[2], args[3], g.shape[1] // 128))
            tids = torch.arange(g.shape[0], device=g.device)
        else:
            tids = args[2].to(torch.int64)
        p = torch.arange(1024, device=g.device)
        r = torch.arange(128, device=g.device)
        scratch += B.fwd_scratch_bytes(*tentry.shape[:2])
        act_tc = _active(tentry, counts)
        active += int(act_tc.sum())
        for c in range(tentry.shape[1]):
            n_started = int((c * 128 < counts).sum())
            started += n_started
            nbytes += n_started * 1024 * 4  # tentry
            act = torch.nonzero(act_tc[:, c])[:, 0]
            if act.numel() == 0:
                continue
            rows = (c * 128 + r)[None, :] < counts[act][:, None]  # (A, 128)
            gc = g[act, c * 128:(c + 1) * 128]  # (A, 128, 10)
            t = tids[act]
            dx = (((t % tiles_x) * 32)[:, None] + p % 32).float()[:, None, :] - gc[..., 0:1]
            dy = (((t // tiles_x) * 32)[:, None] + p // 32).float()[:, None, :] - gc[..., 1:2]
            power = -0.5 * (gc[..., 2:3] * dx * dx + gc[..., 4:5] * dy * dy) - gc[..., 3:4] * dx * dy
            alpha = torch.clamp(gc[..., 5:6] * torch.exp(power), max=0.99)
            hit = (power <= 0) & (alpha >= 1.0 / 255.0) & rows[..., None]
            n_rows = int(rows.sum())
            pairs += n_rows * 1024
            hits += int(hit.sum())
            nbytes += n_rows * 10 * 4
        nbytes += counts.numel() * 4 * (1 if name == "blend_cm" else 2)  # counts (and tids or sblk)
        nbytes += out.shape[0] * 5 * out.shape[2] * 4
    ops = pairs * OPS_PER_PAIR + hits * OPS_PER_HIT
    sfu = pairs * SFU_PER_PAIR + hits * SFU_PER_HIT
    return {"pairs": pairs, "hits": hits, "bytes": nbytes, "ops": ops, "sfu": sfu, "started": started,
            "active": active, "scratch_bytes": scratch, **_bound(nbytes, ops, sfu)}


def _fwd_entries(blend):
    """The forward wrappers and their plain versions, by launch-counter name."""
    kern = {"blend_cm": blend.blend_cm_fwd, "blend_permuted_gm": blend.blend_permuted_gm_fwd,
            "blend_runs": blend.blend_runs_fwd}
    plain = {"blend_cm": blend.blend_cm_plain, "blend_permuted_gm": blend.blend_permuted_gm_plain,
             "blend_runs": blend.blend_runs_plain}
    return kern, plain


def _same_bits(a, b):
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _hold_fwd(name, calls, kern, plain):
    """A forward kernel against its plain version on ``calls``: finite,
    tentry bitwise equal (the backward reads it) and so the same active
    (tile, chunk) pairs, out within KERNEL_TOL, rows 5-7 of out exactly 0,
    and a second launch on the same inputs bitwise equal (no atomics).
    Returns (max |delta| of rgb/acc, depth and tentry, the kernel's (out,
    tentry) per call)."""
    import torch

    err = {"rgb_acc": 0.0, "depth": 0.0, "tentry": 0.0}
    outs = []
    for args in calls:
        ko, kt = kern(*args)
        ko2, kt2 = kern(*args)
        po, pt = plain(*args)
        torch.cuda.synchronize()
        what = f"{name} {tuple(args[0].shape)}"
        if not (bool(torch.isfinite(ko).all()) and bool(torch.isfinite(kt).all())):
            raise RuntimeError(f"{what}: non-finite kernel output")
        if bool(torch.any(ko[:, 5:] != 0)):
            raise RuntimeError(f"{what}: rows 5-7 of out are not zero")
        if not (_same_bits(ko, ko2) and _same_bits(kt, kt2)):
            raise RuntimeError(f"{what}: two launches on the same inputs differ")
        if kt.numel():
            err["tentry"] = max(err["tentry"], float((kt - pt).abs().max()))
        if not _same_bits(kt, pt):
            raise RuntimeError(f"{what}: tentry differs from the plain version's, max |d| {err['tentry']:.3e}")
        if not torch.equal(_active(kt, args[1]), _active(pt, args[1])):
            raise RuntimeError(f"{what}: the active (tile, chunk) pairs differ")
        if ko.numel():
            err["rgb_acc"] = max(err["rgb_acc"], float((ko[:, [0, 1, 2, 4]] - po[:, [0, 1, 2, 4]]).abs().max()))
            err["depth"] = max(err["depth"], float((ko[:, 3] - po[:, 3]).abs().max()))
        outs.append((ko, kt))
    for k, tol in KERNEL_TOL.items():
        if not err[k] <= tol:
            raise RuntimeError(f"{name}: max |kernel - plain| {k} {err[k]:.3e} > {tol}")
    return err, outs


def check_kernels(blend, captured, tag="[kernels]", per="frame"):
    """Phase 3: each forward kernel against its plain version on the
    captured full-width inputs (_hold_fwd); times per frame (or step) in
    turns plain, kernel, kernel, plain, then each call's own: CUDA events
    around the wrapper, and the device time of each of its launches."""
    import torch

    kern, plain = _fwd_entries(blend)
    results = {}
    with torch.no_grad():  # a step's captured g is part of its graph
        for name, calls in captured.items():
            if not calls:
                raise RuntimeError(f"the {per} made no {name} call")
            err, outs = _hold_fwd(name, calls, kern[name], plain[name])
            work = _work(name, calls, outs)
            shapes = [tuple(a[0].shape) for a in calls]
            print(f"{tag} {name}: {len(calls)} call(s) per {per}, shapes {shapes}, max|d| rgb/acc "
                  f"{err['rgb_acc']:.3e} depth {err['depth']:.3e} tentry {err['tentry']:.3e}; tentry bitwise equal, "
                  f"the same {work['active']} active of {work['started']} started (tile, chunk) pairs, rows 5-7 "
                  f"zero, a second launch bitwise equal; scratch {work['scratch_bytes']} bytes per {per}")

            def run(fns):
                return lambda: [fns[name](*a) for a in calls]

            for fn in (run(kern), run(plain)):  # warm up
                fn()
            torch.cuda.synchronize()
            p1 = _event_ms(run(plain), 3)
            k1 = _event_ms(run(kern), 20)
            k2 = _event_ms(run(kern), 20)
            p2 = _event_ms(run(plain), 3)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            print(f"{tag} {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.3f}/{p2:.3f} ms per {per}; "
                  f"{work['pairs']} (Gaussian, pixel) pairs ({work['hits']} with alpha >= 1/255), "
                  f"{work['ops']} operations ({work['sfu']} exp/log1p), {work['bytes']} bytes, "
                  f"bound {work['bound_ms']:.4f} ms by {work['bound_term']}")
            ops = 0  # distinct device operations a call, from the profile (the most of the calls)
            for a, o in zip(calls, outs):
                ms_call = _event_ms(lambda a=a: kern[name](*a), 10)
                w = _work(name, [a], [o])
                dev, n_ops = _device_ms(lambda a=a: kern[name](*a))
                ops = max(ops, n_ops)
                print(f"{tag} {name} call {tuple(a[0].shape)}: {ms_call:.4f} ms; device {dev} "
                      f"({n_ops} device operations a call); {w['active']} of {w['started']} started chunks "
                      f"active, {w['pairs']} pairs, scratch {w['scratch_bytes']} bytes, bound {w['bound_ms']:.4f} ms "
                      f"by {w['bound_term']}")
            results[name] = dict(err=err, ms=ms, plain_ms=plain_ms, launches_per_frame=len(calls),
                                 device_ops_per_call=ops, shapes=shapes, **work)
    return results


def check_oracle(device):
    """Phase 3, last: the tiled renderer (through the blend kernel) against the exact
    O(N * pixels) oracle on a small seeded scene on the card, at the CPU
    tests' bounds (image and alpha 3e-5, depth 2e-4)."""
    import torch

    from riggs_tpu_torch.camera import make_camera
    from riggs_tpu_torch.render.oracle import rasterize_oracle
    from riggs_tpu_torch.render.tiles import rasterize_tiled

    rng = np.random.default_rng(10)
    n = 300
    q = rng.normal(size=(n, 4))
    args = [torch.tensor(a, dtype=torch.float32, device=device) for a in (
        rng.normal(size=(n, 3)) * 0.5, rng.uniform(size=(n, 3)), rng.uniform(0.2, 0.95, size=n),
        np.exp(rng.uniform(-3.5, -2.0, size=(n, 3))), q / np.linalg.norm(q, axis=1, keepdims=True),
        [0.2, 0.1, 0.4])]
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 96, 96, fovx=1.0, fovy=1.0, device=device)
    a = rasterize_tiled(cam, *args, max_per_tile=256)
    b = rasterize_oracle(cam, *args)
    errs = {k: float((a[k] - b[k]).abs().max()) for k in ("image", "alpha", "depth")}
    print(f"[oracle] tiled (kernel) vs oracle, {n} Gaussians at 96x96: max|d| image {errs['image']:.3e} "
          f"alpha {errs['alpha']:.3e} depth {errs['depth']:.3e}; max tile count {int(a['max_count'])}")
    for k, tol in (("image", 3e-5), ("alpha", 3e-5), ("depth", 2e-4)):
        if not errs[k] <= tol:
            raise RuntimeError(f"tiled vs oracle: max |d| {k} {errs[k]:.3e} > {tol}")
    if int(a["overflow"]) or float(a["alpha"].max()) <= 0.5:
        raise RuntimeError("oracle scene: overflow or nothing in view")


def _compare(a, b, what, tag="[slice]"):
    """Two renders of one frame held to PATH_TOL."""
    errs = {k: float((a[k2] - b[k2]).abs().max()) for k, k2 in
            (("image", "render"), ("alpha", "alpha"), ("depth", "depth"))}
    print(f"{tag} {what}: max|d| image {errs['image']:.3e} alpha {errs['alpha']:.3e} depth {errs['depth']:.3e}")
    for k, tol in PATH_TOL.items():
        if not errs[k] <= tol:
            raise RuntimeError(f"{what}: max |d| {k} {errs[k]:.3e} > {tol}")


def _check_frame(out, size, what):
    import torch

    img = out["render"] if isinstance(out, dict) else out
    if tuple(img.shape) != (size, size, 3) or not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"{what}: bad image {tuple(img.shape)}")
    if isinstance(out, dict):
        if int(out["overflow_tiles"]) or int(out["overflow_rect"]):
            raise RuntimeError(f"{what}: overflow tiles {int(out['overflow_tiles'])} rect {int(out['overflow_rect'])}")
        if float(out["alpha"].max()) <= 0.5:
            raise RuntimeError(f"{what}: the avatar is not in view")


def profile_frames(gs, skel, cam, bg, cap, kw, label, frame_ms, n=5):
    """Phase 5: where a frame's time goes. The host clock splits
    skeleton_forward from render (each ended by a synchronize); the
    profiler's device time per kernel name, summed over the frames, gives
    the device's busy time, and beside the unprofiled frame time its idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.render.api import render
    from riggs_tpu_torch.train.stage2 import _eval_image

    split = {"skeleton_forward": 0.0, "render": 0.0}
    with torch.no_grad():
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d = SW.skeleton_forward(skel, gs.xyz, i / n, gs.motion_mask)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            render(cam, gs, bg, d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                   d_scaling=torch.zeros_like(d["d_scaling"]), active_sh_degree=gs.max_sh_degree,
                   max_per_tile=cap, **kw)
            torch.cuda.synchronize()
            split["skeleton_forward"] += (t1 - t0) * 1e3 / n
            split["render"] += (time.perf_counter() - t1) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            _eval_image(gs, skel, cam, i / n, bg, max_per_tile=cap, **kw)
        torch.cuda.synchronize()
    kernels = _device_ops(prof.key_averages())
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time")
    groups = {}
    for e in kernels:
        name = e.key
        g = ("gemm" if "gemm" in name else "blend kernel" if "blend_fwd" in name
             else "sort" if "Sort" in name or "sort" in name else "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    # the MLPs' matrix products: 2 * d_in * d_out per row and layer, one row
    # for the PoseMLP, one per capacity slot for the skinning and detail MLPs
    rows = {"pose_mlp": 1, "weight_mlp": gs.capacity, "detail_mlp": gs.capacity}
    gemm_flop = sum(2 * lin.in_features * lin.out_features * rows[name.split(".")[0]]
                    for name, lin in skel.named_modules() if isinstance(lin, torch.nn.Linear))
    print(f"[profile] {label}: host clock skeleton_forward {split['skeleton_forward']:.2f} ms, render "
          f"{split['render']:.2f} ms; device busy {busy:.2f} ms of {frame_ms:.2f} ms per frame "
          f"(idle share {1 - busy / frame_ms:.3f}), {sum(e.count for e in kernels) // n} kernel launches and "
          f"{sum(e.count for e in kernels if 'HtoD' in e.key) // n} host-to-device copies per frame; "
          f"MLP products {gemm_flop / 1e9:.1f} GFLOP per frame, "
          f"{gemm_flop / groups.get('gemm', float('nan')) / 1e9:.1f} TFLOP/s in the GEMM kernels; "
          "device ms per frame by kind "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    for e in top:
        print(f"[profile]   {e.self_device_time_total / 1e3 / n:8.3f} ms  {e.count // n:4d} launches  {e.key[:90]}")


def _work_bwd(name, calls, offset=0):
    """Bytes and operations the backward calls of one step need on this data
    (the function's needs, not blend_bwd's two sweeps and zero writes).
    Pairs are the (row, pixel) pairs of rows before the tile's count, in
    chunks that some pixel enters with T >= 1e-4, at the pixels that do;
    hits are those whose alpha reaches 1/255. Bytes: counts (and tids), the
    g rows of those chunks and the five used rows of dout of the tiles that
    have one read once, tentry read for the chunks that start before the
    count, and the ten attributes of dg written for every row before the
    count (the window gathers' backward passes those on and zeroes the rest)."""
    import torch

    from riggs_tpu_torch.render import blend as B

    pairs = hits = nbytes = 0
    for args in calls:
        if name == "blend_cm_bwd":
            g, counts, tentry, dout, tiles_x = args
            gt = g[:, :10].transpose(1, 2)
            tids = torch.arange(g.shape[0], device=g.device) + offset
        elif name == "blend_runs_bwd":
            g, counts, sblk, tentry, dout, tiles_x = args
            gt = B._runs_windows(g, B.runs_blocks(counts, sblk, tentry.shape[1], g.shape[1] // 128))
            tids = torch.arange(gt.shape[0], device=g.device)
        else:
            g, counts, tids, tentry, dout, tiles_x = args
            gt, tids = g, tids.to(torch.int64)
        counts = torch.clamp(counts.to(torch.int64), max=gt.shape[1])
        p = torch.arange(1024, device=g.device)
        r = torch.arange(128, device=g.device)
        used = torch.zeros(gt.shape[0], dtype=torch.bool, device=g.device)
        for c in range(tentry.shape[1]):
            started = c * 128 < counts
            nbytes += int(started.sum()) * 1024 * 4  # tentry
            live = tentry[:, c] >= 1e-4  # (T, P)
            act = torch.nonzero(started & live.any(dim=1))[:, 0]
            if act.numel() == 0:
                continue
            used[act] = True
            rows = (c * 128 + r)[None, :] < counts[act][:, None]
            gc = gt[act, c * 128:(c + 1) * 128]
            t = tids[act]
            dx = (((t % tiles_x) * 32)[:, None] + p % 32).float()[:, None, :] - gc[..., 0:1]
            dy = (((t // tiles_x) * 32)[:, None] + p // 32).float()[:, None, :] - gc[..., 1:2]
            power = -0.5 * (gc[..., 2:3] * dx * dx + gc[..., 4:5] * dy * dy) - gc[..., 3:4] * dx * dy
            alpha = torch.clamp(gc[..., 5:6] * torch.exp(power), max=0.99)
            pair = rows[..., None] & live[act][:, None, :]
            pairs += int(pair.sum())
            hits += int(((power <= 0) & (alpha >= 1.0 / 255.0) & pair).sum())
            nbytes += int(rows.sum()) * 10 * 4  # g rows
        nbytes += counts.numel() * 4 * (1 if name == "blend_cm_bwd" else 2)  # counts (and tids or sblk)
        nbytes += int(used.sum()) * 5 * dout.shape[2] * 4  # dout
        nbytes += int(counts.sum()) * 10 * 4  # dg
    ops = pairs * OPS_PER_PAIR_BWD + hits * OPS_PER_HIT_BWD
    sfu = pairs * SFU_PER_PAIR_BWD + hits * SFU_PER_HIT_BWD
    return {"pairs": pairs, "hits": hits, "bytes": nbytes, "ops": ops, "sfu": sfu, **_bound(nbytes, ops, sfu)}


def _column_err(a, b, axis):
    """Per column (``axis``): max |a - b| and max |b|."""
    dims = tuple(d for d in range(a.dim()) if d != axis % a.dim())
    return (a - b).abs().amax(dim=dims), b.abs().amax(dim=dims)


def check_bwd_kernels(blend, captured, tag="[train]"):
    """Each backward kernel against its plain version on the inputs it got
    in a real full-width step (one call per blend call of the step): per dg
    column max |delta| <= 1e-3 * max |plain column|, exact zeros where the
    kernel must write them; times in turns plain, kernel, kernel, plain."""
    import torch

    kern = {"blend_cm_bwd": blend.blend_cm_bwd, "blend_permuted_gm_bwd": blend.blend_permuted_gm_bwd,
            "blend_runs_bwd": blend.blend_runs_bwd}
    plain = {"blend_cm_bwd": blend.blend_cm_bwd_plain, "blend_permuted_gm_bwd": blend.blend_permuted_gm_bwd_plain,
             "blend_runs_bwd": blend.blend_runs_bwd_plain}
    results = {}
    with torch.no_grad():  # the captured g is a saved tensor of the step's graph
        for name, calls in captured.items():
            results[name] = _check_bwd_kernel(name, calls, kern, plain, tag)
    return results


def _check_bwd_kernel(name, calls, kern, plain, tag="[train]"):
    """One backward kernel of check_bwd_kernels."""
    import torch

    if not calls:
        raise RuntimeError(f"the step made no {name} call")
    err, rel = _hold_bwd(name, calls, kern[name], plain[name])
    print(f"{tag} {name}: {len(calls)} launch(es) per step, shapes {[tuple(a[0].shape) for a in calls]}; "
          f"per dg column max|d| / max|plain|: " + " ".join(f"{v:.2e}" for v in rel[:10].tolist())
          + f"; max|d| {float(err.max()):.3e}; exact zeros where due; a second launch bitwise equal")

    def run(fns):
        return lambda: [fns[name](*a) for a in calls]

    for fn in (run(kern), run(plain)):  # warm up
        fn()
    torch.cuda.synchronize()
    p1 = _event_ms(run(plain), 2)
    k1 = _event_ms(run(kern), 10)
    k2 = _event_ms(run(kern), 10)
    p2 = _event_ms(run(plain), 2)
    work = _work_bwd(name, calls)
    print(f"{tag} {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.3f}/{p2:.3f} ms per step; "
          f"{work['pairs']} live (Gaussian, pixel) pairs ({work['hits']} with alpha >= 1/255), "
          f"{work['ops']} operations ({work['sfu']} exp/log1p), {work['bytes']} bytes, "
          f"bound {work['bound_ms']:.4f} ms by {work['bound_term']}")
    # each call on its own: where a step's backward time goes (the ladder's
    # buckets); CUDA events around the wrapper, and the device time of its
    # kernels by name (torch.profiler), which leaves out the host's share
    for a in calls:
        ms = _event_ms(lambda a=a: kern[name](*a), 10)
        w = _work_bwd(name, [a])
        dev, n_ops = _device_ms(lambda a=a: kern[name](*a))
        print(f"{tag} {name} call {tuple(a[0].shape)}: {ms:.4f} ms; device {dev} ({n_ops} device operations a "
              f"call); {w['pairs']} live pairs, bound {w['bound_ms']:.4f} ms by {w['bound_term']}")
    return dict(err=float(err.max()), rel=float(rel.max()), ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                launches_per_step=len(calls), **work)


def _device_ms(fn, n=10):
    """Device ms per call of fn by kernel name (torch.profiler over n calls),
    as "name ms, ...", and the number of distinct device operations
    (kernels, memsets) a call makes (distinct names: robust to the few
    records the profiler drops)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in _device_ops(prof.key_averages()):
        m = re.search(r"\w+(<[^>]*>)?(?=\()", e.key)  # the kernel's name and template arguments
        key = m.group(0) if m else e.key[:30]
        times[key] = times.get(key, 0.0) + e.self_device_time_total / 1e3 / n
    text = ", ".join(f"{k} {v:.4f}" for k, v in sorted(times.items(), key=lambda kv: -kv[1])) or "not measured"
    return text, len(times)


def _zero_mask(name, args):
    """Where a backward kernel must write exact zeros: the rows of inactive
    (tile, chunk) pairs (the chunk starts past the count, or no pixel enters
    it with T >= 1e-4) and the channel-major padding rows; gaussian-major
    rows past the count; in the runs layout every slot but the active pairs'
    own blocks (the spare block included)."""
    import torch

    from riggs_tpu_torch.render import blend as B

    g, counts, tentry = args[0], args[1].to(torch.int64), args[-3]
    T, C = tentry.shape[:2]
    active = _active(tentry, counts)  # (T, C)
    if name == "blend_runs_bwd":
        m2b = g.shape[1] // 128
        blk = B.runs_blocks(args[1], args[2], C, m2b)
        own = torch.zeros(m2b, dtype=torch.bool, device=g.device)
        own[blk[active & (blk < m2b - 1)]] = True
        mask = (~own).repeat_interleave(128)[None, :].repeat(16, 1)
        mask[10:] = True
        return mask
    rows = (~active).repeat_interleave(128, dim=1)  # (T, MAX)
    if name == "blend_cm_bwd":
        mask = rows[:, None, :].repeat(1, 16, 1)
        mask[:, 10:] = True
        return mask
    rows |= torch.arange(C * 128, device=g.device)[None, :] >= counts[:, None]
    return rows[:, :, None].expand(-1, -1, 10)


def _hold_bwd(name, calls, kern, plain):
    """A backward kernel against its plain version on ``calls``: finite, per
    dg column max |delta| <= BWD_TOL * max |plain column|, exact zeros where
    _zero_mask says, and a second launch on the same inputs bitwise equal
    (no atomics). Returns the per-column max |delta| and relative error."""
    import torch

    axis = {"blend_cm_bwd": 1, "blend_permuted_gm_bwd": 2, "blend_runs_bwd": 0}[name]
    err = torch.zeros(10 if axis == 2 else 16, dtype=torch.float64)
    scale = torch.zeros_like(err)
    for args in calls:
        kd, pd = kern(*args), plain(*args)
        kd2 = kern(*args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(kd).all()):
            raise RuntimeError(f"{name}: non-finite kernel output")
        if bool(kd[_zero_mask(name, args)].any()):
            raise RuntimeError(f"{name} {tuple(args[0].shape)}: dg is not zero where it must be")
        if not torch.equal(kd.view(torch.int32), kd2.view(torch.int32)):
            raise RuntimeError(f"{name} {tuple(args[0].shape)}: two launches on the same inputs differ")
        e, s = _column_err(kd, pd, axis)
        err = torch.maximum(err, e.double().cpu())
        scale = torch.maximum(scale, s.double().cpu())
    rel = torch.where(scale > 0, err / scale.clamp(min=1e-300), err)
    if not float(rel.max()) <= BWD_TOL:
        raise RuntimeError(f"{name}: kernel vs plain column error {float(rel.max()):.3e} > {BWD_TOL}")
    return err, rel


EDGE_TILES_X = 2  # a 2 x 2-tile image
EDGE_CHUNKS = 64
# one faint tile of 64 full chunks, live past half of them; a count ending
# mid-chunk; an empty tile; a tile whose pixels all fall below 1e-4 in chunk
# 3 (of 10, the count ending mid-chunk): chunks 4-9 inactive (the forward
# skips them, the backward's chunks 0-2 carry chunk 3's suffix)
EDGE_COUNTS = (EDGE_CHUNKS * 128, 1000, 0, 1250)
EDGE_SATURATE = (3, 3)  # (row, chunk)


def _edge_windows(rng, tiles, chunks):
    """Seeded gaussian-major windows (T, chunks * 128, 10) for [edges]:
    row t renders ``tiles[t]``; splats of 1.5-4 px around it, faint in row
    0 (its pixels stay live through most of the 64 chunks), and in chunk
    EDGE_SATURATE[1] of row EDGE_SATURATE[0] two opaque layers on a 4 px
    grid that cover the tile."""
    T, n = len(tiles), chunks * 128
    g = np.zeros((T, n, 10), np.float32)
    ox = np.array([(t % EDGE_TILES_X) * 32 for t in tiles], np.float32)[:, None]
    oy = np.array([(t // EDGE_TILES_X) * 32 for t in tiles], np.float32)[:, None]
    g[..., 0] = ox + rng.uniform(-4, 36, (T, n))
    g[..., 1] = oy + rng.uniform(-4, 36, (T, n))
    a = 1.0 / rng.uniform(1.5, 4.0, (T, n)) ** 2
    g[..., 2] = a
    g[..., 3] = rng.uniform(-0.3, 0.3, (T, n)) * a
    g[..., 4] = a * rng.uniform(0.5, 1.5, (T, n))
    g[..., 5] = rng.uniform(0.05, 0.6, (T, n))
    g[0, :, 5] = rng.uniform(0.01, 0.05, n)
    g[..., 6:9] = rng.uniform(0, 1, (T, n, 3))
    g[..., 9] = rng.uniform(1, 5, (T, n))
    r, c = EDGE_SATURATE
    grid = np.arange(0, 32, 4, dtype=np.float32) + 2
    xs, ys = np.meshgrid(grid, grid)
    rows = slice(c * 128, (c + 1) * 128)
    g[r, rows, 0] = ox[r] + np.tile(xs.ravel(), 2)
    g[r, rows, 1] = oy[r] + np.tile(ys.ravel(), 2)
    g[r, rows, 2:5] = [1 / 25, 0.0, 1 / 25]
    g[r, rows, 5] = 0.98
    return g


def edges_phase(blend, device):
    """[edges]: on the seeded EDGE_COUNTS windows, each forward kernel held
    to its plain version (_hold_fwd: tentry bitwise equal, the same active
    pairs, out within KERNEL_TOL, rows 5-7 zero, a second launch bitwise
    equal) and the cases checked on the kernel's tentry; then each backward
    kernel against its plain version on that tentry, per dg column max
    |delta| <= BWD_TOL * max |plain|, exact zeros where due and a second
    launch bitwise equal; then T == 0 and C == 0 return without a launch,
    forward and backward (out and the runs dg all zero).

    Alone, after a build: python3 -c "import chip_smoke as s; from
    riggs_tpu_torch.render import blend; s.edges_phase(blend, 'cuda')"."""
    import torch

    rng = np.random.default_rng(11)
    tids = (3, 1, 0, 2)
    counts = torch.tensor(EDGE_COUNTS, dtype=torch.int32, device=device)
    dout = torch.tensor(rng.normal(size=(len(tids), 8, 1024)), dtype=torch.float32, device=device)
    w_cm = _edge_windows(np.random.default_rng(12), range(len(tids)), EDGE_CHUNKS)
    w_gm = _edge_windows(np.random.default_rng(12), tids, EDGE_CHUNKS)
    for t, n in enumerate(EDGE_COUNTS):
        w_cm[t, n:, 5] = 0.0  # the caller masks opacity past the count (channel-major windows)
        w_gm[t, n:, 5:] = [0.99, 1e3, 1e3, 1e3, 1e3]  # garbage the kernel must mask
    g_cm = torch.zeros((len(tids), 16, w_cm.shape[1]), dtype=torch.float32, device=device)
    g_cm[:, :10] = torch.tensor(w_cm, device=device).transpose(1, 2)
    g_gm = torch.tensor(w_gm, device=device)
    tids_t = torch.tensor(tids, dtype=torch.int32, device=device)
    # the runs layout: each tile's count rows as one run, zeros past it, a spare block of garbage
    nblk = [-(-n // 128) for n in EDGE_COUNTS]
    sblk = torch.tensor(np.concatenate([[0], np.cumsum(nblk)[:-1]]), dtype=torch.int32, device=device)
    m2b = sum(nblk) + 1
    g_runs = torch.zeros((16, m2b * 128), dtype=torch.float32, device=device)
    for t, n in enumerate(EDGE_COUNTS):
        s = int(sblk[t]) * 128
        g_runs[:10, s:s + n] = torch.tensor(w_cm[t, :n].T, device=device)
    g_runs[:10, -128:] = 7.0

    kern, plain = _fwd_entries(blend)
    with torch.no_grad():
        te = {}
        for name, args in (("blend_cm", (g_cm, counts, EDGE_TILES_X)),
                           ("blend_permuted_gm", (g_gm, counts, tids_t, EDGE_TILES_X)),
                           ("blend_runs", (g_runs, counts, sblk, EDGE_CHUNKS, EDGE_TILES_X))):
            err, outs = _hold_fwd(name, [args], kern[name], plain[name])
            te[name] = outs[0][1]
            print(f"[edges] {name} {tuple(args[0].shape)}, counts {EDGE_COUNTS}: max|d| rgb/acc "
                  f"{err['rgb_acc']:.3e} depth {err['depth']:.3e}; tentry bitwise equal, the same active pairs, "
                  "rows 5-7 zero, a second launch bitwise equal")
        r, c = EDGE_SATURATE
        for name, t in te.items():
            live = t.amax(dim=2) >= 1e-4
            if not (bool(live[r, c]) and not bool(live[r, c + 1:].any()) and int(live[0].sum()) > EDGE_CHUNKS // 2):
                raise RuntimeError(f"[edges] {name}: the windows do not give the cases: "
                                   f"live chunks {live.sum(1).tolist()}")
        cases = (("blend_cm_bwd", (g_cm, counts, te["blend_cm"], dout, EDGE_TILES_X)),
                 ("blend_permuted_gm_bwd", (g_gm, counts, tids_t, te["blend_permuted_gm"], dout, EDGE_TILES_X)),
                 ("blend_runs_bwd", (g_runs, counts, sblk, te["blend_runs"], dout, EDGE_TILES_X)))
        for name, args in cases:
            _, rel = _hold_bwd(name, [args], getattr(blend, name), getattr(blend, f"{name}_plain"))
            print(f"[edges] {name} {tuple(args[0].shape)} on the forward kernel's tentry: per dg column "
                  "max|d| / max|plain| " + " ".join(f"{v:.2e}" for v in rel[:10].tolist())
                  + "; exact zeros where due; a second launch bitwise equal")
        print(f"[edges] active chunks per tile {_active(te['blend_cm'], counts).sum(1).tolist()} of "
              f"{[min(EDGE_CHUNKS, -(-n // 128)) for n in EDGE_COUNTS]} started; "
              f"tile {r} live in chunk {c}, below 1e-4 from chunk {c + 1} on")

        # no work: T == 0 and C == 0 launch nothing
        before = dict(blend.launches)
        for T, C in ((0, 10), (2, 0)):
            z = dict(counts=torch.zeros(T, dtype=torch.int32, device=device),
                     tentry=torch.ones((T, C, 1024), device=device), dout=torch.ones((T, 8, 1024), device=device))
            fwd = (blend.blend_cm_fwd(torch.ones((T, 16, C * 128), device=device), z["counts"], 2),
                   blend.blend_permuted_gm_fwd(torch.ones((T, C * 128, 10), device=device), z["counts"],
                                               z["counts"], 2),
                   blend.blend_runs_fwd(torch.ones((16, 256), device=device), z["counts"], z["counts"], C, 2))
            dg = blend.blend_cm_bwd(torch.ones((T, 16, C * 128), device=device), z["counts"], z["tentry"], z["dout"], 2)
            dgm = blend.blend_permuted_gm_bwd(torch.ones((T, C * 128, 10), device=device), z["counts"], z["counts"],
                                              z["tentry"], z["dout"], 2)
            dgr = blend.blend_runs_bwd(torch.ones((16, 256), device=device), z["counts"], z["counts"], z["tentry"],
                                       z["dout"], 2)
            torch.cuda.synchronize()
            if any(o.shape != (T, 8, 1024) or bool(o.any()) or te_.shape != (T, C, 1024) for o, te_ in fwd):
                raise RuntimeError(f"[edges] T={T} C={C}: a forward gave wrong shapes or a nonzero out")
            if dg.shape != (T, 16, C * 128) or dgm.shape != (T, C * 128, 10) or bool(dgr.any()):
                raise RuntimeError(f"[edges] T={T} C={C}: wrong shapes or a nonzero runs dg")
        if blend.launches != before:
            raise RuntimeError(f"[edges] T == 0 or C == 0 launched a kernel: {before} -> {blend.launches}")
        print("[edges] T == 0 and C == 0: no launch, forward or backward; out and the runs dg all zero")


# the offset entry on the serving frame's real windows: three shards [k, k + n)
# of the 625 tiles, k = 0, a multiple of tiles_x and 313 (the second half of a
# 2-way split, not a multiple of 25)
OFFSET_SHARDS = ((0, 313), (150, 313), (313, 312))


def offset_edges_phase(blend, calls):
    """[edges], the offset entry (``pallas_blend_offset``): on the serving
    frame's plain windows (``calls``: its blend_cm call), the full call's
    out, tentry and dg (a seeded cotangent) by the plain entry, then each
    shard [k, k + n) of OFFSET_SHARDS blended with tile_offset k: out,
    tentry and dg bitwise equal to rows k..k+n-1 of the full call; each
    offset forward held to its plain version (_hold_fwd) and each offset
    backward too (_hold_bwd, on the kernel's tentry). Returns the forward
    and backward results of the last shard (the second of a 2-way split):
    errors, CUDA-event times of kernel and plain version, bound."""
    import torch

    (g, counts, tiles_x), = calls
    T = g.shape[0]
    dout = torch.randn((T, 8, 1024), device=g.device, generator=torch.Generator(g.device).manual_seed(3))
    with torch.no_grad():
        out_f, te_f = blend.blend_cm_fwd(g, counts, tiles_x)
        dg_f = blend.blend_cm_bwd(g, counts, te_f, dout, tiles_x)
        res = {}
        for k, n in OFFSET_SHARDS:
            rows = slice(k, k + n)
            args = (g[rows].contiguous(), counts[rows].contiguous(), tiles_x)
            kern = lambda g_, c_, tx, k=k: blend.blend_cm_fwd(g_, c_, tx, k, counter="blend_cm_offset")
            plain = lambda g_, c_, tx, k=k: blend.blend_cm_plain(g_, c_, tx, k)
            err, outs = _hold_fwd("blend_cm_offset", [args], kern, plain)
            out, te = outs[0]
            bargs = (args[0], args[1], te, dout[rows].contiguous(), tiles_x)
            kern_b = lambda g_, c_, te_, do_, tx, k=k: blend.blend_cm_bwd(g_, c_, te_, do_, tx, k,
                                                                           counter="blend_cm_offset_bwd")
            plain_b = lambda g_, c_, te_, do_, tx, k=k: blend.blend_cm_bwd_plain(g_, c_, te_, do_, tx, k)
            aerr, rel = _hold_bwd("blend_cm_bwd", [bargs], kern_b, plain_b)
            dg = kern_b(*bargs)
            torch.cuda.synchronize()
            same = {"out": _same_bits(out, out_f[rows]), "tentry": _same_bits(te, te_f[rows]),
                    "dg": _same_bits(dg, dg_f[rows])}
            if not all(same.values()):
                raise RuntimeError(f"[edges] offset {k}: not the rows of the full call: {same}")
            print(f"[edges] blend_cm_offset tiles [{k}, {k + n}) of {T} (tiles_x {tiles_x}), offset {k}: out, tentry "
                  f"and dg bitwise equal to the full call's rows; vs plain max|d| rgb/acc {err['rgb_acc']:.3e} depth "
                  f"{err['depth']:.3e}, tentry bitwise; dg per column max|d| / max|plain| <= {float(rel.max()):.2e}")
            res[k] = dict(fwd=dict(err=err, args=args, outs=outs, kern=kern, plain=plain),
                          bwd=dict(err=float(aerr.max()), rel=float(rel.max()), args=bargs, kern=kern_b,
                                   plain=plain_b))
        # times and bounds on the last shard
        k, n = OFFSET_SHARDS[-1]
        f, b = res[k]["fwd"], res[k]["bwd"]
        work = _work("blend_cm", [f["args"]], f["outs"], offset=k)
        plain_ms = _event_ms(lambda: f["plain"](*f["args"]), 3)
        ms = _event_ms(lambda: f["kern"](*f["args"]), 20)
        work_b = _work_bwd("blend_cm_bwd", [b["args"]], offset=k)
        plain_b_ms = _event_ms(lambda: b["plain"](*b["args"]), 2)
        ms_b = _event_ms(lambda: b["kern"](*b["args"]), 20)
        print(f"[edges] blend_cm_offset on the {n}-tile shard: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; "
              f"{work['pairs']} pairs ({work['hits']} hits), bound {work['bound_ms']:.4f} ms by {work['bound_term']}")
        print(f"[edges] blend_cm_offset_bwd on the {n}-tile shard: kernel {ms_b:.4f} ms, plain {plain_b_ms:.3f} ms; "
              f"{work_b['pairs']} pairs ({work_b['hits']} hits), bound {work_b['bound_ms']:.4f} ms by "
              f"{work_b['bound_term']}")
    fwd = dict(err=max(max(r["fwd"]["err"][q] for q in ("rgb_acc", "depth")) for r in res.values()), ms=ms,
               plain_ms=plain_ms, **{q: work[q] for q in ("bound_ms", "bound_by", "bound_term")})
    bwd = dict(err=max(r["bwd"]["err"] for r in res.values()), rel=max(r["bwd"]["rel"] for r in res.values()),
               ms=ms_b, plain_ms=plain_b_ms,
               **{q: work_b[q] for q in ("bound_ms", "bound_by", "bound_term")})
    return fwd, bwd


def build_training(gs, skel, cam, bg, device):
    """The [train] set-up: a frame whose target is the avatar at t = 0.5
    posed by a second seeded SkeletonWarp, with that pose's bone samples
    projected as thinned points (padded, masked); pre_d_xyz / pre_d_joints
    of four frames from the same second skeleton; the configuration with
    both optional MLPs on."""
    import torch

    from riggs_tpu_torch.camera import project_nodes_2d
    from riggs_tpu_torch.data.dataset import Frame
    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.train.config import Config
    from riggs_tpu_torch.train.stage2 import eval_image, sample_skeleton_points

    gen = torch.Generator(device=device).manual_seed(1)
    skel2 = SW.init_skeleton_warp(skel.joints.cpu().numpy(), PARENTS, K=-1, use_skinning_mlp=True,
                                  use_template_offsets=True, generator=gen, device=device)
    target = eval_image(gs, skel2, cam, 0.5, bg)
    # the [stage1] phase's motion-mask loss reads the target's silhouette
    alpha_mask = (frame(gs, skel2, cam, bg, t=0.5, max_per_tile=8192)["alpha"] > 0.5).to(torch.float32)
    with torch.no_grad():
        d = SW.skeleton_forward(skel2, gs.xyz, 0.5, gs.motion_mask)
        pix = project_nodes_2d(cam, sample_skeleton_points(d["d_nodes"], PARENTS))
        thinned = torch.zeros((N_THIN, 2), device=device)
        thinned[: pix.shape[0]] = pix
        pre = [SW.skeleton_forward(skel2, gs.xyz, t, gs.motion_mask) for t in np.linspace(0.0, 1.0, N_FRAMES)]
    fr = Frame(cam=dataclasses.replace(cam, fid=torch.tensor(0.5, device=device)), image=target,
               alpha_mask=alpha_mask, thinned=thinned, thinned_mask=torch.arange(N_THIN, device=device) < pix.shape[0])
    pre_d_xyz = torch.stack([p["d_xyz"] for p in pre])
    pre_d_joints = torch.stack([p["d_nodes"] for p in pre])
    cfg = Config()
    cfg.model.sh_degree = SH_DEGREE
    cfg.model.use_template_offsets = cfg.model.use_skinning_weight_mlp = True
    return fr, pre_d_xyz, pre_d_joints, cfg


def fresh_state(gs, skel, it, device):
    """A Stage2State at iteration ``it`` with fresh Adam moments; the
    skeleton is a copy (a step updates it in place)."""
    import torch

    from riggs_tpu_torch.models.gaussians import init_densify_stats
    from riggs_tpu_torch.train.optim import adam_init
    from riggs_tpu_torch.train.stage2 import Stage2State

    sk = copy.deepcopy(skel)
    return Stage2State(gs=gs, skel=sk, opt_gs=adam_init(gs.params_dict()), opt_skel=adam_init(sk.params_dict()),
                       stats_gs=init_densify_stats(gs.capacity, device=device),
                       proj_loss=torch.full((N_FRAMES,), 1.0e5, device=device),
                       it=torch.tensor(it, dtype=torch.int32, device=device))


def frame_grads(gs, skel, frame, pre_d_xyz, pre_d_joints, bg, cfg, it, kw):
    """stage2_frame_loss at iteration ``it`` with the flags the step derives
    there (stage2_flags), and its gradient tree {"gs", "skel", "m2b"} (m2b
    is mean2d_bias)."""
    import torch

    from riggs_tpu_torch.train.optim import grad_tree
    from riggs_tpu_torch.train.stage2 import stage2_flags, stage2_frame_loss

    st = fresh_state(gs, skel, it, gs.device)
    params = {"gs": {k: v.detach().requires_grad_(True) for k, v in gs.params_dict().items()},
              "skel": st.skel.params_dict(), "m2b": torch.zeros_like(gs.xyz[:, :2], requires_grad=True)}
    loss, (_, aux, _) = stage2_frame_loss(params, st, frame, UID, bg, params["m2b"], pre_d_xyz[UID],
                                          pre_d_joints[UID], **stage2_flags(cfg, it, UID, 0), **kw)
    return loss, aux, grad_tree(loss, params)


def _groups(grads):
    """Parameter group -> its gradient leaves (skel groups by top-level key)."""
    from riggs_tpu_torch.train.optim import tree_leaves

    out = {f"gs.{k}": [v] for k, v in grads["gs"].items()}
    out.update({f"skel.{k}": tree_leaves(v) for k, v in grads["skel"].items()})
    out["mean2d_bias"] = [grads["m2b"]]
    return out


def check_grads(grads, it):
    """Finite everywhere; nonzero exactly in the groups the flags at ``it``
    give a gradient: in warmup only the skeleton's radius and pose MLP and
    the Gaussians' motion-mask feature (through d_xyz) are reached, the
    image's weight being 0; at 15001 every group is."""
    import torch

    warm_live = {"gs.feature", "skel.radius", "skel.pose"}
    for name, leaves in _groups(grads).items():
        if not all(bool(torch.isfinite(v).all()) for v in leaves):
            raise RuntimeError(f"it={it}: non-finite gradient in {name}")
        nonzero = any(bool(v.any()) for v in leaves)
        want = name in warm_live if it == 0 else True
        if nonzero != want:
            raise RuntimeError(f"it={it}: gradient of {name} is {'nonzero' if nonzero else 'zero'}, the flags say otherwise")


def compare_grads(gk, gp, label, groups=None, tag="[train]"):
    """Two gradients of one loss (gp the reference path's): per parameter
    leaf, max |delta| over max |plain|; the worst leaf of each group
    (``groups`` maps a gradient tree to {group: leaves}, the stage-2 groups
    by default) is printed and held to BWD_TOL."""
    groups = groups or _groups
    worst = {}
    plain = groups(gp)
    for name, lk in groups(gk).items():
        r = 0.0
        for a, b in zip(lk, plain[name]):
            s, e = float(b.abs().max()), float((a - b).abs().max())
            r = max(r, e / s if s > 0 else e)
        worst[name] = r
    print(f"{tag} gradient, {label}: per group max|d| / max|plain| "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    bad = {k: v for k, v in worst.items() if not v <= BWD_TOL}
    if bad:
        raise RuntimeError(f"{tag} gradient, {label}: above {BWD_TOL}: {bad}")


def _host_ms(fn, reps):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _device_ops(events):
    """The device's operations among profiler events: the CUDA events but
    the device-side copies of host ranges (the port's ``riggs.*`` spans)."""
    import torch

    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.key.startswith("riggs.")]


def profile_steps(step, gs, skel, frame, pre_d_xyz, pre_d_joints, bg, kw, label, step_ms, n=3):
    """Device busy time and idle share per training step (torch.profiler),
    and the step's three parts by the port's spans (``riggs_tpu_torch.trace``):
    the backward (``riggs.backward.grad``), the update (``riggs.optim.adam``)
    and the forward (``riggs.entry.stage2_step`` less those two), their host
    time under the profiler and the device time of the kernels launched
    inside them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    st = fresh_state(gs, skel, TRAIN_ITS[-1], gs.device)
    st, _ = step(st, frame, UID, bg, pre_d_xyz, pre_d_joints, it=TRAIN_ITS[-1], **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            st, _ = step(st, frame, UID, bg, pre_d_xyz, pre_d_joints, it=TRAIN_ITS[-1], **kw)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = _device_ops(events)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time")
    spans = {k: max((e for e in events if e.key == name and e.device_type != torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.cpu_time_total, default=None)
             for k, name in (("entry", "riggs.entry.stage2_step"), ("backward", "riggs.backward.grad"),
                             ("update", "riggs.optim.adam"))}
    if any(e is None or e.cpu_time_total <= 0 for e in spans.values()):
        raise RuntimeError(f"the profile lacks a span of stage2_step: {spans}")
    ms = {k: e.cpu_time_total / 1e3 / n for k, e in spans.items()}
    parts = {"forward": ms["entry"] - ms["backward"] - ms["update"], "backward": ms["backward"],
             "update": ms["update"]}
    # host time only: the backward's kernels are launched from autograd's
    # device thread, outside the span as the profiler attributes them
    print(f"[train] {label}: step parts by host time under the profiler (stage2_step's spans): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items()))
    groups = {}
    for e in kernels:
        k = e.key
        g = ("gemm" if "gemm" in k else "blend bwd kernel" if "blend_bwd" in k else "blend fwd kernel"
             if "blend_fwd" in k else "sort" if "sort" in k.lower() else "scatter/index" if "index" in k.lower()
             or "scatter" in k.lower() else "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / n
    print(f"[train] profile {label}: device busy {busy:.2f} ms of {step_ms:.2f} ms per step "
          f"(idle share {1 - busy / step_ms:.3f}), {sum(e.count for e in kernels) // n} kernel launches and "
          f"{sum(e.count for e in kernels if 'HtoD' in e.key) // n} host-to-device copies per step; "
          "device ms per step by kind " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[train]   {e.self_device_time_total / 1e3 / n:8.3f} ms  {e.count // n:4d} launches  {e.key[:90]}")
    return busy


def train_phase(blend, gs, skel, cam, bg, cap, ladder):
    """Phase 6: the stage-2 training step at full width on both window
    paths. Returns (launch counts of the counted run, forward and backward
    kernel results, the training frame)."""
    import torch

    from riggs_tpu_torch.train.optim import tree_leaves
    from riggs_tpu_torch.train.stage2 import make_stage2_auto

    t0 = time.perf_counter()
    frame, pre_d_xyz, pre_d_joints, cfg = build_training(gs, skel, cam, bg, DEVICE)
    step = make_stage2_auto(cfg, template_idx=0)
    paths = (("plain windows", dict(max_per_tile=cap)), ("ladder", dict(max_per_tile=cap, tile_ladder=ladder)))
    torch.cuda.synchronize()
    print(f"[train] set-up {time.perf_counter() - t0:.1f} s: target at t=0.5 from a second skeleton, "
          f"{int(frame.thinned_mask.sum())} thinned points, {N_FRAMES} pre_d frames, uid {UID} (the template frame)")

    # the main path: make_stage2_auto steps, counters zeroed just before
    torch.cuda.synchronize()
    blend.reset_launches()
    for it in TRAIN_ITS:
        for label, kw in paths:
            st = fresh_state(gs, skel, it, DEVICE)
            for k in range(TRAIN_STEPS):
                st, m = step(st, frame, UID, bg, pre_d_xyz, pre_d_joints, it=it + k, **kw)
                if not all(bool(torch.isfinite(v).all()) for k, v in m.items() if v.is_floating_point()):
                    raise RuntimeError(f"[train] it={it} {label}: non-finite metric")
                if int(m["overflow_tiles"]) or int(m["overflow_rect"]):
                    raise RuntimeError(f"[train] it={it} {label}: overflow {int(m['overflow_tiles'])}/{int(m['overflow_rect'])}")
            leaves = tree_leaves(st.gs.params_dict()) + tree_leaves(st.skel.params_dict())
            if not all(bool(torch.isfinite(v).all()) for v in leaves) or int(st.it) != it + TRAIN_STEPS:
                raise RuntimeError(f"[train] it={it} {label}: non-finite parameters or wrong it")
            if it < cfg.opt.skeleton_warm_up and not torch.equal(st.gs.xyz, gs.xyz):
                raise RuntimeError("[train] the Gaussians moved in warmup")
            print(f"[train] it={it} {label}: {TRAIN_STEPS} steps, loss {float(m['loss']):.5f} img {float(m['img_loss']):.5f} "
                  f"psnr {float(m['psnr']):.2f} d_xyz {float(m['d_xyz_loss']):.3e} chamfer {float(m['chamfer']):.2f}")
    torch.cuda.synchronize()
    launches = dict(blend.launches)
    print(f"[train] launch counters over the training main path: {launches}")
    for name in ("blend_cm", "blend_permuted_gm", "blend_cm_bwd", "blend_permuted_gm_bwd"):
        if launches[name] <= 0:
            raise RuntimeError(f"the training path never launched {name}")

    # gradients: finite, nonzero where the flags give one, kernel vs plain path
    for it in TRAIN_ITS:
        for label, kw in paths:
            loss, aux, gk = frame_grads(gs, skel, frame, pre_d_xyz, pre_d_joints, bg, cfg, it, kw)
            if not bool(torch.isfinite(loss)) or not all(bool(torch.isfinite(v)) for v in aux.values()):
                raise RuntimeError(f"[train] it={it} {label}: non-finite loss")
            check_grads(gk, it)
            if it == TRAIN_ITS[-1]:
                with _PlainBlend(blend):
                    _, _, gp = frame_grads(gs, skel, frame, pre_d_xyz, pre_d_joints, bg, cfg, it, kw)
                compare_grads(gk, gp, f"kernel vs plain-version path, it={it} {label}")
            del gk
    print(f"[train] gradients finite and nonzero exactly where the flags give one, at it {TRAIN_ITS}")

    # each forward and backward kernel against its plain version on a real
    # step's inputs
    names = ("blend_cm_bwd", "blend_permuted_gm_bwd")
    fwd_names = ("blend_cm_fwd", "blend_permuted_gm_fwd")
    captured, fwd_captured = {}, {}
    for (label, kw), name, fname in zip(paths, names, fwd_names):
        with _Capture(blend, names + fwd_names) as c:
            step(fresh_state(gs, skel, TRAIN_ITS[-1], DEVICE), frame, UID, bg, pre_d_xyz, pre_d_joints,
                 it=TRAIN_ITS[-1], **kw)
        captured[name] = c.calls[name]
        fwd_captured[fname.removesuffix("_fwd")] = c.calls[fname]
    fres = check_kernels(blend, fwd_captured, tag="[train]", per="step")
    bres = check_bwd_kernels(blend, captured)
    # the held arguments keep that step's autograd graph, and with it the
    # skeleton parameters' gradient accumulators made on the default stream,
    # alive: the step's CUDA graph is captured below
    del captured, fwd_captured, c

    # step time: the whole make_stage2_auto step by host clock around
    # synchronized steps; then the profile, with the step's parts
    for label, kw in paths:
        st = fresh_state(gs, skel, TRAIN_ITS[-1], DEVICE)

        def full_step():
            nonlocal st
            st, _ = step(st, frame, UID, bg, pre_d_xyz, pre_d_joints, it=TRAIN_ITS[-1], **kw)

        for _ in range(4):  # warm-up: the step's key is captured as a CUDA graph on its fourth call
            full_step()
        full = _host_ms(full_step, 5)
        g = step.graphs
        print(f"[train] {label}: step {full:.2f} ms (host clock, synchronized, it={int(st.it)}, {SIZE}x{SIZE}; "
              f"a replayed CUDA graph: {g.captures} captures, {g.replays} replays, {g.eager} eager calls so far)")
        st = replay_vs_eager(step, cfg, st, frame, pre_d_xyz, pre_d_joints, bg, kw, label)
        # the spans are the eager step's: a fresh step runs its first calls eagerly
        profile_steps(make_stage2_auto(cfg, template_idx=0), gs, skel, frame, pre_d_xyz, pre_d_joints, bg, kw,
                      label, full)
        sync_audit(f"make_stage2_auto ({label}, it={TRAIN_ITS[-1]})", full_step)
    return launches, fres, bres, frame


def replay_vs_eager(step, cfg, st, frame, pre_d_xyz, pre_d_joints, bg, kw, label):
    """From one state at full width, a replay of ``step``'s graph and two
    first (eager) calls of fresh make_stage2_auto steps: every metric and
    every state leaf of the replay equal the eager step's bit for bit, or,
    where two eager steps differ too (atomics reorder sums), within the s2
    cell's limits (each metric's and each leaf's max |d| over its max |value|;
    portbench/limits/s2-dnerf800.train.json). Returns the replay's state."""
    import torch

    from riggs_tpu_torch.io.checkpoint import state_leaves
    from riggs_tpu_torch.train.stage2 import make_stage2_auto

    limits = json.loads((Path(__file__).resolve().parent / "portbench" / "limits" /
                         "s2-dnerf800.train.json").read_text())["limits"]
    args = (frame, UID, bg, pre_d_xyz, pre_d_joints)
    starts = [copy.deepcopy(st), copy.deepcopy(st)]
    replays = step.graphs.replays
    st, m = step(st, *args, it=TRAIN_ITS[-1], **kw)
    if step.graphs.replays != replays + 1:
        raise RuntimeError(f"[train] {label}: the step did not replay its graph")
    runs = []
    for s0 in starts:
        eager = make_stage2_auto(cfg, template_idx=0)
        runs.append(eager(s0, *args, it=TRAIN_ITS[-1], **kw))
        if eager.graphs.eager != 1:
            raise RuntimeError(f"[train] {label}: a fresh step's first call was not eager")
    torch.cuda.synchronize()

    def gaps(a, b):
        """(bitwise, the worst gap of a metric and of a state leaf) of two
        steps' results."""
        (sa, ma), (sb, mb) = a, b
        la, lb = state_leaves(sa), state_leaves(sb)
        pairs = [("metrics", k, ma[k], mb[k]) for k in mb] + [("state", k, la[k][0], lb[k][0]) for k in lb]
        same, worst = True, {"metrics": 0.0, "state": 0.0}
        for group, name, x, y in pairs:
            x, y = x.detach(), y.detach()
            if torch.equal(x, y):
                continue
            same = False
            if not y.is_floating_point():
                raise RuntimeError(f"[train] {label}: {name} differs: {x} / {y}")
            scale = float(y.abs().max())
            err = float((x.double() - y.double()).abs().max())
            worst[group] = max(worst[group], err / scale if scale else err)
        return same, worst

    rep_same, rep_gap = gaps((st, m), runs[0])
    eager_same, eager_gap = gaps(runs[1], runs[0])
    print(f"[train] {label}: a replay at {SIZE}x{SIZE}, {CAPACITY} slots against the eager step: bitwise "
          f"{rep_same}, worst gaps {rep_gap}; two eager steps bitwise {eager_same}, worst gaps {eager_gap}")
    if not rep_same and (eager_same or rep_gap["metrics"] > limits["loss"] or rep_gap["state"] > limits["change"]):
        raise RuntimeError(f"[train] {label}: the replay differs from the eager step: {rep_gap} (two eager steps "
                           f"{eager_gap}; limits loss {limits['loss']}, change {limits['change']})")
    return st


def _turns(fa, fb, reps):
    """Host ms per call of fa and fb in turns a, b, b, a (synchronized)."""
    a1 = _host_ms(fa, reps)
    b1 = _host_ms(fb, reps)
    b2 = _host_ms(fb, reps)
    a2 = _host_ms(fa, reps)
    return (a1, a2), (b1, b2)


def runs_phase(blend, gs, skel, cam, bg, cap, target):
    """Phase 7: the aligned-runs render path. The main path, counted:
    render_auto(binning="runs") of the frame at RUNS_T, then the gradient of
    a photometric loss against the [train] target through render with the
    caps render_auto settled on. Then the frame and the gradient against the
    plain-window path's, each runs kernel against its plain version on the
    frame's real inputs, and both paths timed in turns."""
    import torch

    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.render import api
    from riggs_tpu_torch.train import losses as L

    with torch.no_grad():
        d = SW.skeleton_forward(skel, gs.xyz, RUNS_T, gs.motion_mask)
    deform = dict(d_xyz=d["d_xyz"], d_rotation=d["d_rotation"], d_scaling=torch.zeros_like(d["d_scaling"]),
                  active_sh_degree=gs.max_sh_degree)
    params = {k: v.detach().requires_grad_(True) for k, v in gs.params_dict().items()}

    def grads(**kw):
        m2b = torch.zeros_like(gs.xyz[:, :2], requires_grad=True)
        out = api.render(cam, gs.replace_params(params), bg, mean2d_bias=m2b, **deform, **kw)
        loss = L.photometric_loss(out["render"], target)
        g = torch.autograd.grad(loss, list(params.values()) + [m2b], allow_unused=True)
        # the feature (motion mask) reaches the frame only through d_xyz, a constant here
        return out, {k: v for k, v in zip([f"gs.{k}" for k in params] + ["mean2d_bias"], g) if v is not None}

    caps = []
    orig = api.render

    def recording(*a, **k):
        caps.append({n: k[n] for n in ("max_per_tile", "max_tiles_per_gaussian", "max_instances")})
        return orig(*a, **k)

    # the main path, counters zeroed just before and read just after
    torch.cuda.synchronize()
    blend.reset_launches()
    api.render = recording
    try:
        with torch.no_grad():
            ra = api.render_auto(cam, gs, bg, binning="runs", max_per_tile=cap, **deform)
    finally:
        api.render = orig
    runs_kw = dict(binning="runs", **caps[-1])
    out_r, g_runs = grads(**runs_kw)
    torch.cuda.synchronize()
    launches = dict(blend.launches)
    print(f"[runs] render_auto(binning='runs') settled on {caps[-1]} after {len(caps)} render(s); "
          f"launch counters over the runs path: {launches}")
    for name in ("blend_runs", "blend_runs_bwd"):
        if launches[name] <= 0:
            raise RuntimeError(f"the runs path never launched {name}")
    _check_frame(ra, SIZE, "runs frame")
    if int(ra["overflow_budget"]):
        raise RuntimeError(f"runs frame: overflow_budget {int(ra['overflow_budget'])}")

    # the same function as the plain windows: frame and gradient
    plain_kw = dict(max_per_tile=cap)
    with torch.no_grad():
        pa = api.render(cam, gs, bg, **deform, **plain_kw)
    _compare(ra, pa, f"runs vs plain-window frame t={RUNS_T}", tag="[runs]")
    _, g_plain = grads(**plain_kw)
    if not all(bool(torch.isfinite(v).all()) for v in g_runs.values()):
        raise RuntimeError("[runs] non-finite gradient")
    as_groups = lambda g: {k: [v] for k, v in g.items()}
    compare_grads(g_runs, g_plain, "runs vs plain-window path", groups=as_groups, tag="[runs]")

    # each runs kernel against its plain version on the frame's real inputs
    with _Capture(blend, ("blend_runs", "blend_runs_bwd")) as c:
        grads(**runs_kw)
    fwd_calls = [(a[0].detach(),) + tuple(a[1:]) for a in c.calls["blend_runs"]]
    with torch.no_grad():
        kres = check_kernels(blend, {"blend_runs": fwd_calls}, tag="[runs]")["blend_runs"]
    bres = check_bwd_kernels(blend, {"blend_runs_bwd": c.calls["blend_runs_bwd"]}, tag="[runs]")["blend_runs_bwd"]
    g_shape = tuple(fwd_calls[0][0].shape)
    del c, fwd_calls

    # which layout wins on this card: frame and gradient, in turns
    def frame_fn(kw):
        return lambda: frame(gs, skel, cam, bg, t=RUNS_T, **kw)

    (p1, p2), (r1, r2) = _turns(frame_fn(plain_kw), frame_fn(runs_kw), 10)
    print(f"[runs] frame (skeleton_forward + render, {SIZE}x{SIZE}): runs {r1:.2f}/{r2:.2f} ms, plain windows "
          f"{p1:.2f}/{p2:.2f} ms (host clock, synchronized, in turns plain, runs, runs, plain); "
          f"g_runs {g_shape} vs windows ({out_r['tile_counts'].numel()}, 16, {cap})")
    (q1, q2), (s1, s2) = _turns(lambda: grads(**plain_kw), lambda: grads(**runs_kw), 5)
    print(f"[runs] gradient (render + photometric loss + backward): runs {s1:.2f}/{s2:.2f} ms, "
          f"plain windows {q1:.2f}/{q2:.2f} ms")
    for what, fa, fb in (("frame", frame_fn(plain_kw), frame_fn(runs_kw)),
                         ("gradient", lambda: grads(**plain_kw), lambda: grads(**runs_kw))):
        profile_runs(what, {"plain windows": fa, "runs": fb})
    return launches, kres, bres


def _by_kind(prof, n):
    """Device ms per call by kind of kernel, from a profile of n calls."""
    import torch

    groups = {}
    for e in _device_ops(prof.key_averages()):
        k = e.key.lower()
        g = ("gemm" if "gemm" in k else "blend fwd" if "blend_fwd" in k else "blend bwd" if "blend_bwd" in k
             else "sort" if "sort" in k else "scatter/index" if "index" in k or "scatter" in k else "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / n
    return groups


def profile_runs(what, fns, n=3):
    """Device busy ms per call of each of ``fns`` (torch.profiler), by kind
    of kernel: the two layouts' device time side by side."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    parts = []
    for label, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        groups = _by_kind(prof, n)
        busy = sum(groups.values())
        if busy <= 0:
            raise RuntimeError("the profiler saw no device time")
        parts.append(f"{label} {busy:.3f} ms (" + ", ".join(f"{k} {v:.3f}" for k, v in sorted(groups.items())) + ")")
    print(f"[runs] device busy per {what}: " + "; ".join(parts))


def _stage1_groups(g):
    """Parameter group -> gradient leaves of a phase-B gradient tree."""
    from riggs_tpu_torch.train.optim import tree_leaves

    out = {f"gs.{k}": [v] for k, v in g["gs"].items()}
    w = g["warp"]
    out.update({"warp.nodes_xyz": [w["nodes"][:, :3]], "warp.nodes_hyper": [w["nodes"][:, 3:]],
                "warp.radius": [w["radius"]], "warp.weight": [w["weight"]], "warp.mlp": tree_leaves(w["mlp"])})
    out["mean2d_bias"] = [g["m2b"]]
    return out


def stage1_setup(gs, bg, fr):
    """[stage1]'s initial state and windows: init_stage1 from the avatar's
    alive points and colours at its capacity (seeded), the log-scales
    jittered; a probe render of ``fr`` gives the plain window (the largest
    tile count with 25% headroom) and a ladder fitted to it. Returns (cfg,
    state, window, ladder, largest tile count)."""
    import torch

    from riggs_tpu_torch.data.dataset import SceneData
    from riggs_tpu_torch.models import node_warp as NW
    from riggs_tpu_torch.ops.sh import C0
    from riggs_tpu_torch.render.api import render, tier_kwargs
    from riggs_tpu_torch.render.ladder import make_tile_ladder
    from riggs_tpu_torch.train.stage1 import init_stage1

    cfg = _stage1_config(gs.capacity)
    n = int(gs.num_alive)
    pts = gs.xyz[:n].cpu().numpy()
    cols = np.clip(gs.features_dc[:n, 0].cpu().numpy() * C0 + 0.5, 0.0, 1.0)
    state0 = init_stage1(SceneData(pts, cols), cfg, generator=torch.Generator(device=DEVICE).manual_seed(2),
                         device=DEVICE)
    # create_from_pcd's splats are isotropic, which leaves the gradient of
    # every rotation (the Gaussians', the warp's d_rotation head) at
    # cancellation noise: shrink the log-scales per axis by a seeded jitter,
    # as training soon makes them anisotropic (no splat grows, so the
    # tiers' rect caps still hold)
    jitter = torch.randn(state0.gs.scaling.shape, generator=torch.Generator(device=DEVICE).manual_seed(4),
                         device=DEVICE)
    state0.gs.scaling = state0.gs.scaling - 0.5 * jitter.abs()
    tiers = (cfg.pipe.max_tiles_per_gaussian, cfg.pipe.mid_cap, cfg.pipe.mid_side)
    with torch.no_grad():
        d = NW.warp_forward(state0.warp, state0.gs.xyz, fr.fid, state0.gs.feature, state0.gs.motion_mask)
        probe = render(fr.cam, state0.gs, bg, d_xyz=d["d_xyz"], d_rotation=d["d_rotation"], max_per_tile=8192,
                       **tier_kwargs(tiers))
    if int(probe["overflow_rect"]):
        raise RuntimeError(f"[stage1] the initial state overflows the rect caps: {int(probe['overflow_rect'])}")
    counts = probe["tile_counts"].cpu().numpy()
    cap1 = int(-(-int(counts.max() * 1.25) // 128) * 128)  # headroom: the steps move the Gaussians
    return cfg, state0, cap1, make_tile_ladder(counts[None]), int(counts.max())


def stage1_phase(blend, gs, cam, bg, frame_train):
    """Phase 8: the stage-1 phase-B step at full width. Returns the launch
    counts of its counted run and the forward, backward and rotation-fit
    kernel results."""
    import torch

    from riggs_tpu_torch.models import node_warp as NW
    from riggs_tpu_torch.ops import geometry as GEO
    from riggs_tpu_torch.train.optim import grad_tree, tree_leaves
    from riggs_tpu_torch.train.stage1 import make_phase_b_auto, phase_b_flags, stage1_frame_loss

    t0 = time.perf_counter()
    fr = frame_train
    cfg, state0, cap1, ladder1, max_count = stage1_setup(gs, bg, fr)
    torch.cuda.synchronize()
    print(f"[stage1] init_stage1 {time.perf_counter() - t0:.1f} s: {int(gs.num_alive)} Gaussians of "
          f"{state0.gs.capacity}, {state0.warp.node_num} nodes, hyper_dim {state0.warp.hyper_dim}, DeformNetwork "
          f"{state0.warp.net.depth}x{state0.warp.net.width} (blender {state0.warp.net.is_blender}); "
          f"max tile count {max_count} -> window {cap1}; ladder {ladder1}")
    step = make_phase_b_auto(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    paths = (("plain windows", dict(max_per_tile=cap1)), ("ladder", dict(max_per_tile=cap1, tile_ladder=ladder1)))
    flags = dict(use_chamfer=True, use_motion_loss=True)

    def fresh(it):
        st = copy.deepcopy(state0)
        return dataclasses.replace(st, it=torch.tensor(it, dtype=torch.int32, device=DEVICE))

    # the main path: make_phase_b_auto steps, counters zeroed just before
    torch.cuda.synchronize()
    blend.reset_launches()
    GEO.reset_launches()
    for it in STAGE1_ITS:
        for label, kw in paths:
            st = fresh(it)
            for k in range(STAGE1_STEPS):
                st, m = step(st, fr, bg, NW.arap_sample_times(gen, device=DEVICE), it=it + k, **flags, **kw)
                if not all(bool(torch.isfinite(v).all()) for k, v in m.items() if v.is_floating_point()):
                    raise RuntimeError(f"[stage1] it={it} {label}: non-finite metric")
                if int(m["overflow_tiles"]) or int(m["overflow_rect"]):
                    raise RuntimeError(f"[stage1] it={it} {label}: overflow {int(m['overflow_tiles'])}/"
                                       f"{int(m['overflow_rect'])}")
            leaves = tree_leaves(st.gs.params_dict()) + tree_leaves(st.warp.params_dict())
            if not all(bool(torch.isfinite(v).all()) for v in leaves) or int(st.it) != it + STAGE1_STEPS:
                raise RuntimeError(f"[stage1] it={it} {label}: non-finite parameters or wrong it")
            print(f"[stage1] it={it} {label}: {STAGE1_STEPS} steps, loss {float(m['loss']):.5f} psnr "
                  f"{float(m['psnr']):.2f} arap {float(m['arap']):.3e} chamfer {float(m['chamfer']):.2f}")
    torch.cuda.synchronize()
    launches = dict(blend.launches, **GEO.launches)
    print(f"[stage1] launch counters over the stage-1 main path: {launches}")
    for name in ("blend_cm", "blend_permuted_gm", "blend_cm_bwd", "blend_permuted_gm_bwd", "estimate_rotations"):
        if launches[name] <= 0:
            raise RuntimeError(f"the stage-1 path never launched {name}")
    if launches["estimate_rotations"] != len(STAGE1_ITS) * len(paths) * STAGE1_STEPS or launches["fit_rotations"]:
        raise RuntimeError(f"[stage1] not one fused rotation fit a step: {launches}")

    # gradients: finite, nonzero where the flags give one, kernel vs plain path
    arap_t = NW.arap_sample_times(gen, device=DEVICE)

    def frame_grads(it, kw):
        st = fresh(it)
        params = {"gs": {k: v.detach().requires_grad_(True) for k, v in st.gs.params_dict().items()},
                  "warp": st.warp.params_dict(), "m2b": torch.zeros_like(st.gs.xyz[:, :2], requires_grad=True)}
        loss, _ = stage1_frame_loss(params, st, fr, bg, params["m2b"], arap_t, **flags, **kw,
                                    **phase_b_flags(cfg, it))
        return loss, grad_tree(loss, params)

    # in warm-up d_xyz and d_rotation are detached: nothing reaches the
    # warp's blend (radius, weight, the nodes' hyper coords) and, at SH 0, no f_rest
    warm_zero = {"gs.f_rest", "warp.nodes_hyper", "warp.radius", "warp.weight"}
    for it in STAGE1_ITS:
        for label, kw in paths:
            loss, gk = frame_grads(it, kw)
            if not bool(torch.isfinite(loss)):
                raise RuntimeError(f"[stage1] it={it} {label}: non-finite loss")
            for name, lv in _stage1_groups(gk).items():
                if not all(bool(torch.isfinite(v).all()) for v in lv):
                    raise RuntimeError(f"[stage1] it={it}: non-finite gradient in {name}")
                nonzero = any(bool(v.any()) for v in lv)
                if nonzero != (it >= cfg.opt.warm_up or name not in warm_zero):
                    raise RuntimeError(f"[stage1] it={it}: gradient of {name} is "
                                       f"{'nonzero' if nonzero else 'zero'}, the flags say otherwise")
            if it == STAGE1_ITS[-1]:
                with _PlainBlend(blend):
                    _, gp = frame_grads(it, kw)
                compare_grads(gk, gp, f"kernel vs plain-version path, it={it} {label}", groups=_stage1_groups,
                              tag="[stage1]")
            del gk
    print(f"[stage1] gradients finite and nonzero exactly where the flags give one, at it {STAGE1_ITS}")

    # each forward and backward kernel against its plain version on a real
    # step's inputs (plain windows: the main and the motion-mask render; the
    # ladder's buckets), with each call's time
    names = ("blend_cm_bwd", "blend_permuted_gm_bwd")
    fwd_names = ("blend_cm_fwd", "blend_permuted_gm_fwd")
    captured, fwd_captured = {}, {}
    with _RotCapture() as rc:
        for (label, kw), name, fname in zip(paths, names, fwd_names):
            with _Capture(blend, names + fwd_names) as c:
                step(fresh(STAGE1_ITS[-1]), fr, bg, arap_t, it=STAGE1_ITS[-1], **flags, **kw)
            captured[name] = c.calls[name]
            fwd_captured[fname.removesuffix("_fwd")] = c.calls[fname]
    fres = check_kernels(blend, fwd_captured, tag="[stage1]", per="step")
    bres = check_bwd_kernels(blend, captured, tag="[stage1]")
    rres = check_rotfit(rc.fits, "[stage1]")
    rres["planted"] = check_rotfit_planted("[stage1]")
    rres["planted_edges"] = check_estimate_planted("[stage1]")
    # the held arguments keep that step's autograd graph, and with it the
    # warp parameters' gradient accumulators made on the default stream,
    # alive: the step's CUDA graph is captured below
    del captured, fwd_captured, rc, c

    # step time and the device's share of it
    for label, kw in paths:
        st = fresh(STAGE1_ITS[-1])

        def one():
            nonlocal st
            st, _ = step(st, fr, bg, NW.arap_sample_times(gen, device=DEVICE), it=STAGE1_ITS[-1], **flags, **kw)

        for _ in range(4):  # warm-up: the step's key is captured as a CUDA graph by its fourth call
            one()
        ms = _host_ms(one, 5)
        g = step.graphs
        print(f"[stage1] {label}: a replayed CUDA graph: {g.captures} captures, {g.replays} replays, {g.eager} eager "
              "calls so far")
        profile_stage1(one, label, ms)
        sync_audit(f"make_phase_b_auto ({label}, it={STAGE1_ITS[-1]})", one)

    # the node warp alone: warp_forward and its backward at the step's shapes
    st = fresh(STAGE1_ITS[-1])
    feat = st.gs.feature.detach().requires_grad_(True)
    leaves = [feat] + tree_leaves(st.warp.params_dict())

    def warp_fb():
        d = NW.warp_forward(st.warp, st.gs.xyz, fr.fid, feat, st.gs.motion_mask)
        torch.autograd.grad(d["d_xyz"].sum() + d["d_rotation"].sum() + d["d_nodes"].sum(), leaves,
                            allow_unused=True)

    warp_fb()
    print(f"[stage1] node warp (warp_forward + its backward, {st.gs.capacity} x {st.warp.node_num}): "
          f"{_event_ms(warp_fb, 5):.3f} ms (CUDA events)")
    return launches, fres, bres, rres


def profile_stage1(one, label, step_ms, n=3, tag="[stage1]", it=STAGE1_ITS[-1]):
    """Device busy time per stage-1 step (torch.profiler), its idle share
    beside the unprofiled step time, and the six costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            one()
        torch.cuda.synchronize()
    kernels = _device_ops(prof.key_averages())
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time")
    print(f"{tag} {label}: step {step_ms:.2f} ms (host clock, synchronized, it={it}, {SIZE}x{SIZE}); "
          f"device busy {busy:.2f} ms (idle share {1 - busy / step_ms:.3f}), "
          f"{sum(e.count for e in kernels) // n} kernel launches per step; device ms per step by kind "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(_by_kind(prof, n).items(), key=lambda kv: -kv[1])))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"{tag}   {e.self_device_time_total / 1e3 / n:8.3f} ms  {e.count // n:4d} launches  {e.key[:90]}")


def _site(func, text):
    """"file:line" of the first line of ``func``'s source that holds ``text``."""
    import inspect

    lines, first = inspect.getsourcelines(func)
    n = next(i for i, line in enumerate(lines) if text in line)
    return f"{Path(inspect.getsourcefile(func)).name}:{first + n}"


def _keep_layout(x):
    """A copy of ``x`` with its strides (a view's layout kept)."""
    import torch

    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device).copy_(x)


class _RotCapture:
    """Record the ARAP fits the losses hand to estimate_rotations: (source,
    target, connectivity), copied with their layouts."""

    def __init__(self):
        from riggs_tpu_torch.ops import arap

        self.arap, self.fits = arap, []

    def __enter__(self):
        self.orig = self.arap.estimate_rotations

        def rec(source, target, conn):
            self.fits.append((_keep_layout(source.detach()), _keep_layout(target.detach()),
                              type(conn)(*(_keep_layout(x) for x in conn))))
            return self.orig(source, target, conn)

        self.arap.estimate_rotations = rec
        return self

    def __exit__(self, *exc):
        self.arap.estimate_rotations = self.orig


def _edge_cov(source, target, conn):
    """sum_k w (t_i - t_j)(s_i - s_j)^T per node in the points' dtype, as
    estimate_rotations_plain forms it."""
    import torch

    from riggs_tpu_torch.ops.arap import edge_matrix

    return torch.einsum("nka,nk,nkb->nab", edge_matrix(target, conn), conn.weight.to(source.dtype),
                        edge_matrix(source, conn))


def _conditioning(cov):
    """Per fit, min(s1 + s2, s1 + d s3, s2 + d s3) / s1 (d = det(U V^T)),
    from a float64 SVD: the error that f32 rounding puts into R scales as
    its inverse, and below ILL_POSED the fit is ill-posed."""
    import torch

    u, sv, vh = torch.linalg.svd(cov.double())
    d = torch.sign(torch.linalg.det(u @ vh))
    low = torch.minimum(torch.minimum(sv[:, 0] + sv[:, 1], sv[:, 0] + d * sv[:, 2]), sv[:, 1] + d * sv[:, 2])
    return low / sv[:, 0].clamp_min(1e-300)


# cycles of the spin kernel (torch.cuda._sleep) that holds the stream while
# the host enqueues _held_ms's calls: about 25 ms, against the 2-3 ms that
# 50 calls of a rotation fit take to enqueue
HOLD_CYCLES = 50_000_000


def _held_ms(fn, reps=50):
    """Device ms a call of ``fn`` with its launches back to back: a spin
    kernel holds the stream while the host enqueues ``reps`` calls between
    two CUDA events, so the events bracket the device's work and the gaps
    between its launches, not the host's. Every launch is counted by
    construction; raises if the hold ended before the host had enqueued
    them all."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    held = not start.query()
    torch.cuda.synchronize()
    if not held:
        raise RuntimeError(f"_held_ms: the stream's hold ended before {reps} calls were enqueued")
    return start.elapsed_time(end) / reps


def check_rotfit(fits, tag):
    """The fused rotation-fit kernel (estimate_rotations) against its plain
    version on the ARAP fits of real steps, as the losses passed them:
    finite, a second launch bitwise equal, max |d R| <= ROTFIT_TOL on the
    well-posed fits (their conditioning from a float64 covariance of the
    same edges), |det R - 1| <= ROTFIT_TOL on every fit, the ill-posed
    fits counted; the covariance entry (fit_rotations) held the same way
    on the float32 covariances of the same edges. Each fit's Jacobi sweeps
    counted by the kernel's debug build (csrc/rotfit.cu,
    ROTFIT_COUNT_SWEEPS), launched here outside the wrapper. On the last
    fit, by CUDA events: the fused call's ms (plain, kernel, kernel, plain),
    its device ms a launch back to back (_held_ms), an empty kernel's (the
    launch floor) both ways, the plain version's, the library chain's
    (edge_matrix twice, einsum, torch.linalg.svd), the chain a stage-1 step
    ran before the fused entry (edge_matrix twice, einsum, fit_rotations),
    the covariance entry's both ways, and the bound."""
    import torch

    from riggs_tpu_torch.ops import arap as A
    from riggs_tpu_torch.ops import geometry as GEO

    if not fits:
        raise RuntimeError(f"{tag}: the step made no rotation fit")
    dbg = GEO.load_library(debug=True)
    err = det_err = scaled = cov_err = 0.0
    n_fits = ill = 0
    debug_same = True
    sweeps = np.zeros(ROTFIT_SWEEPS + 1, np.int64)
    for s, t, conn in fits:
        R, R2 = A.estimate_rotations(s, t, conn), A.estimate_rotations(s, t, conn)
        P = A.estimate_rotations_plain(s, t, conn)
        C = GEO.fit_rotations(_edge_cov(s, t, conn))
        sw, Rd = torch.zeros(s.shape[0], dtype=torch.int32, device=s.device), torch.empty_like(R)
        code = dbg.riggs_rotfit_sweeps_to(sw.data_ptr())
        code = code or GEO.launch(dbg.riggs_estimate_rotations, s.device, *A.kernel_args(s, t, conn, Rd))
        torch.cuda.synchronize()
        if code != 0:
            raise RuntimeError(f"{tag} estimate_rotations' debug build: CUDA error {code}")
        if not bool(torch.isfinite(R).all()):
            raise RuntimeError(f"{tag} estimate_rotations {tuple(s.shape)}: non-finite kernel output")
        if not _same_bits(R, R2):
            raise RuntimeError(f"{tag} estimate_rotations {tuple(s.shape)}: two launches on the same inputs differ")
        debug_same &= _same_bits(R, Rd)
        ratio = _conditioning(_edge_cov(s.double(), t.double(), conn))
        well = ratio >= ILL_POSED
        d = (R - P).abs().amax(dim=(-2, -1)).double()
        if bool(well.any()):
            err = max(err, float(d[well].max()))
            scaled = max(scaled, float((d * ratio)[well].max()))
            cov_err = max(cov_err, float((C - P).abs().amax(dim=(-2, -1))[well].max()))
        det_err = max(det_err, float((torch.linalg.det(R.double()) - 1.0).abs().max()),
                      float((torch.linalg.det(C.double()) - 1.0).abs().max()))
        n_fits += s.shape[0]
        ill += int((~well).sum())
        sweeps += np.bincount(sw.cpu().numpy(), minlength=ROTFIT_SWEEPS + 1)
    if not (err <= ROTFIT_TOL and cov_err <= ROTFIT_TOL and det_err <= ROTFIT_TOL):
        raise RuntimeError(f"{tag} rotation fit: max |d R| {err:.3e} (fused) / {cov_err:.3e} (covariance entry) "
                           f"on well-posed fits, max |det R - 1| {det_err:.3e}; the limit is {ROTFIT_TOL}")
    s, t, conn = fits[-1]
    cov = _edge_cov(s, t, conn)
    lib = GEO.load_library()
    dev = s.device

    def chain():
        return torch.linalg.svd(_edge_cov(s, t, conn))

    fused, plain = (lambda: A.estimate_rotations(s, t, conn)), (lambda: A.estimate_rotations_plain(s, t, conn))
    empty, cov_fit = (lambda: GEO.launch(lib.riggs_rotfit_empty, dev)), (lambda: GEO.fit_rotations(cov))
    before = lambda: GEO.fit_rotations(_edge_cov(s, t, conn))
    for fn in (fused, plain, empty, cov_fit, chain, before):
        fn()
    torch.cuda.synchronize()
    p1 = _event_ms(plain, 5)
    k1, k2 = _event_ms(fused, 50), _event_ms(fused, 50)
    p2 = _event_ms(plain, 5)
    floor = _event_ms(empty, 50)
    library = _event_ms(chain, 5)
    before_ms = _event_ms(before, 20)
    cov_call = _event_ms(cov_fit, 50)
    cov_plain = _event_ms(lambda: GEO.fit_rotations_plain(cov), 5)
    cov_library = _event_ms(lambda: torch.linalg.svd(cov), 5)
    dev_ms, floor_dev, cov_dev = _held_ms(fused), _held_ms(empty), _held_ms(cov_fit)
    n, K = conn.nn_idx.shape
    bound = _bound(_rotfit_bytes(n, K), 0, 0)
    cov_bound = _bound(n * ROTFIT_COV_BYTES, 0, 0)
    sweep_text = ", ".join(f"{k}: {c}" for k, c in enumerate(sweeps) if c)
    print(f"{tag} estimate_rotations: {len(fits)} fit(s) of {n_fits} nodes, {ill} ill-posed (conditioning < "
          f"{ILL_POSED}); max |d R| {err:.3e} on the well-posed (x conditioning {scaled:.3e}), the covariance "
          f"entry {cov_err:.3e}; max |det R - 1| {det_err:.3e}; a second launch bitwise equal; Jacobi sweeps "
          f"{{{sweep_text}}} (the debug build's rotations bitwise equal: {debug_same})")
    print(f"{tag} estimate_rotations ({n} nodes, K = {K}), CUDA events: a call {k1:.4f}/{k2:.4f} ms, device "
          f"{dev_ms:.5f} ms a launch back to back; the launch floor, an empty kernel: a call {floor:.4f} ms, device "
          f"{floor_dev:.5f} ms; the chain this replaced on the stage-1 step (edge_matrix x2, einsum, "
          f"fit_rotations) {before_ms:.4f} ms; plain {p1:.3f}/{p2:.3f} ms; library chain (edge_matrix x2, einsum, "
          f"torch.linalg.svd) {library:.3f} ms; fit_rotations on the same covariances: a call {cov_call:.4f} ms, "
          f"device {cov_dev:.5f} ms, plain {cov_plain:.3f} ms, torch.linalg.svd {cov_library:.3f} ms; bound "
          f"{bound['bound_ms']:.2e} ms by {bound['bound_by']} (covariance entry {cov_bound['bound_ms']:.2e})")
    return dict(err=err, cov_err=cov_err, det_err=det_err, scaled_err=scaled, fits=n_fits, ill_posed=ill,
                sweeps={k: int(c) for k, c in enumerate(sweeps) if c}, debug_same=debug_same, ms=(k1 + k2) / 2,
                device_ms=dev_ms, floor_ms=floor, floor_device_ms=floor_dev, before_ms=before_ms,
                plain_ms=(p1 + p2) / 2, library_ms=library, cov_ms=cov_call, cov_device_ms=cov_dev,
                cov_plain_ms=cov_plain, cov_library_ms=cov_library, cov_bound_ms=cov_bound["bound_ms"], batch=n, K=K,
                **bound)


def _rotations(rng, n):
    """n random proper rotations (float64), from unit quaternions."""
    q = rng.normal(size=(n, 4))
    w, x, y, z = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1).reshape(n, 3, 3)


def planted_covariances(seed=13):
    """Fits whose answer csrc/rotfit.cu documents or whose conditioning is
    planted, by kind: cov = 0; rank 1 s u v^T (integer entries, exactly
    rank 1, and random ones rounded to f32); rank 2 U diag(s1, s2, 0) V^T;
    near-reflections U diag(1, 1/2, -(1/2 - e)) V^T (d = -1, conditioning
    e, from well- to ill-posed); a NaN entry; U diag(1, 0.7, 0.4) V^T
    scaled by 1e-30. Returns {kind: (cov (n, 3, 3) f32, u, v)} (u, v: rank 1's
    vectors, else None)."""
    rng = np.random.default_rng(seed)
    out = {"zero": (np.zeros((4, 3, 3)), None, None)}
    quads = np.array([[1, 2, 2], [2, 3, 6], [1, 4, 8], [4, 4, 7], [2, 6, 9], [6, 6, 7]], np.float64)
    sign = lambda n: np.where(rng.uniform(size=(n, 3)) < 0.5, -1.0, 1.0)
    iu, iv = rng.integers(0, len(quads), 24), rng.integers(0, len(quads), 24)
    a, b = quads[iu] * sign(24), quads[iv] * sign(24)
    perm = lambda x: np.take_along_axis(x, np.argsort(rng.uniform(size=x.shape), -1), -1)
    a, b = perm(a), perm(b)
    out["rank 1 exact"] = (a[:, :, None] * b[:, None, :], a / np.linalg.norm(a, axis=-1, keepdims=True),
                           b / np.linalg.norm(b, axis=-1, keepdims=True))
    u, v = rng.normal(size=(24, 3)), rng.normal(size=(24, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    out["rank 1 rounded"] = (np.exp(rng.uniform(-3, 3, (24, 1, 1))) * u[:, :, None] * v[:, None, :], u, v)
    U, V = _rotations(rng, 24), _rotations(rng, 24)
    s = np.stack([np.ones(24), np.exp(rng.uniform(-4, 0, 24)), np.zeros(24)], -1)
    out["rank 2"] = (np.einsum("nab,nb,ncb->nac", U, s, V), None, None)
    e = np.repeat([1e-1, 3e-2, 3e-3, 1e-3, 1e-4, 1e-5, 0.0], 4)
    U, V = _rotations(rng, len(e)), _rotations(rng, len(e))
    s = np.stack([np.ones(len(e)), np.full(len(e), 0.5), -(0.5 - e)], -1)
    out["near reflection"] = (np.einsum("nab,nb,ncb->nac", U, s, V), None, None)
    nan = rng.normal(size=(4, 3, 3))
    nan.reshape(4, 9)[np.arange(4), rng.integers(0, 9, 4)] = np.nan
    out["nan"] = (nan, None, None)
    U, V = _rotations(rng, 8), _rotations(rng, 8)
    out["scaled 1e-30"] = (np.einsum("nab,b,ncb->nac", U, [1.0, 0.7, 0.4], V) * 1e-30, None, None)
    return {k: (np.asarray(c, np.float32), u, v) for k, (c, u, v) in out.items()}


def check_rotfit_planted(tag):
    """The rotation-fit kernel on planted_covariances, each kind held to
    what csrc/rotfit.cu says: cov = 0 -> the identity bitwise; rank 1 -> a
    proper rotation with R v = u (|R v - u| <= ROTFIT_TOL); a NaN entry ->
    NaN in every entry; every other fit finite with |det R - 1| and
    |R R^T - I| <= ROTFIT_TOL, and within ROTFIT_TOL of the plain version
    where well-posed; the 1e-30 batch within ROTFIT_TOL of the kernel and
    the plain version on the same matrices unscaled. Returns the readings."""
    import torch

    from riggs_tpu_torch.ops import geometry as GEO

    fails, res = [], {}
    for kind, (c, u, v) in planted_covariances().items():
        cov = torch.as_tensor(c, device="cuda")
        R = GEO.fit_rotations(cov)
        Rd = R.double()
        if kind == "nan":
            if not bool(torch.isnan(R).all()):
                fails.append(f"{kind}: not NaN in every entry")
            res[kind] = dict(n=len(c))
            continue
        if not bool(torch.isfinite(R).all()):
            fails.append(f"{kind}: non-finite output")
            continue
        eye = torch.eye(3, dtype=torch.float64, device="cuda")
        det_err = float((torch.linalg.det(Rd) - 1.0).abs().max())
        orth_err = float((Rd @ Rd.transpose(-1, -2) - eye).abs().max())
        # the 1e-30 batch is held, like the plain version, at its unscaled size
        base = cov if kind != "scaled 1e-30" else \
            torch.as_tensor(c.astype(np.float64) * 1e30, dtype=torch.float32, device="cuda")
        well = _conditioning(base) >= ILL_POSED
        plain_err = float((R - GEO.fit_rotations_plain(base)).abs().amax(dim=(-2, -1))[well].max()) \
            if bool(well.any()) else None
        r = dict(n=len(c), ill_posed=int((~well).sum()), det_err=det_err, orth_err=orth_err, plain_err=plain_err)
        if det_err > ROTFIT_TOL or orth_err > ROTFIT_TOL:
            fails.append(f"{kind}: |det R - 1| {det_err:.3e}, |R R^T - I| {orth_err:.3e}")
        if plain_err is not None and plain_err > ROTFIT_TOL:
            fails.append(f"{kind}: max |d R| {plain_err:.3e} against the plain version on the well-posed fits")
        if kind == "zero" and not _same_bits(R, eye.float().expand_as(R).contiguous()):
            fails.append(f"{kind}: not the identity")
        if u is not None:
            rv = torch.einsum("nab,nb->na", Rd, torch.as_tensor(v, device="cuda"))
            r["rv_err"] = float((rv - torch.as_tensor(u, device="cuda")).abs().max())
            if r["rv_err"] > ROTFIT_TOL:
                fails.append(f"{kind}: |R v - u| {r['rv_err']:.3e}")
        if kind == "scaled 1e-30":
            r["scale_err"] = float((R - GEO.fit_rotations(base)).abs().max())
            if r["scale_err"] > ROTFIT_TOL:
                fails.append(f"{kind}: max |d R| {r['scale_err']:.3e} against the unscaled fits")
        res[kind] = r
    print(f"{tag} fit_rotations on planted fits: " + "; ".join(
        f"{k} {r['n']}" + "".join(f", {m} {r[m]:.2e}" for m in ("det_err", "orth_err", "plain_err", "rv_err",
                                                                   "scale_err") if r.get(m) is not None)
        + (f", {r['ill_posed']} ill-posed" if "ill_posed" in r else "") for k, r in res.items()))
    if fails:
        raise RuntimeError(f"{tag} fit_rotations on planted fits: " + "; ".join(fails))
    return res


def planted_edge_sets():
    """Edge sets whose fit csrc/rotfit.cu documents: points 1-10 at k (1, 2,
    2) and their targets at k (2, 3, 6) (k = 1..10, exact in f32), point 0
    at the origin of both, point 11 off the line. Nodes 0-10 take ten
    neighbours on the line, all valid, so every edge is collinear and the
    covariance exactly rank 1 (R v = u, v and u the two directions
    normalized); node 11 takes the same neighbours, all invalid (the
    identity). Returns (source, target, Connectivity, u, v) on the card."""
    import torch

    from riggs_tpu_torch.ops.arap import Connectivity

    k = np.arange(12, dtype=np.float32)[:, None]
    src = k * np.array([1.0, 2.0, 2.0], np.float32)
    tgt = k * np.array([2.0, 3.0, 6.0], np.float32)
    src[0] = tgt[0] = 0.0
    src[11], tgt[11] = (3.0, -1.0, 0.5), (1.0, 4.0, -2.0)
    idx = np.stack([[j for j in range(11) if j != i][:10] for i in range(11)] + [list(range(1, 11))]).astype(np.int32)
    valid = np.ones((12, 10), bool)
    valid[11] = False
    w = np.where(valid, np.float32(0.1), np.float32(0.0)).astype(np.float32)
    on = lambda a: torch.as_tensor(a, device="cuda")
    conn = Connectivity(nn_idx=on(idx), weight=on(w), valid=on(valid))
    u, v = np.array([2.0, 3.0, 6.0]) / 7.0, np.array([1.0, 2.0, 2.0]) / 3.0
    return on(src), on(tgt), conn, u, v


def check_estimate_planted(tag):
    """The fused entry on planted_edge_sets: the node with no valid edge
    gives the identity bitwise; each node with collinear edges a proper
    rotation with R v = u (|R v - u|, |det R - 1| and |R R^T - I| <=
    ROTFIT_TOL). Returns the readings."""
    import torch

    from riggs_tpu_torch.ops import arap as A

    src, tgt, conn, u, v = planted_edge_sets()
    R = A.estimate_rotations(src, tgt, conn).double()
    eye = torch.eye(3, dtype=torch.float64, device="cuda")
    line = R[:11]
    res = dict(identity=_same_bits(R[11], eye),
               rv_err=float((line @ torch.as_tensor(v, device="cuda") - torch.as_tensor(u, device="cuda")).abs().max()),
               det_err=float((torch.linalg.det(line) - 1.0).abs().max()),
               orth_err=float((line @ line.transpose(-1, -2) - eye).abs().max()))
    print(f"{tag} estimate_rotations on planted edge sets: no valid edge -> the identity bitwise {res['identity']}; "
          f"collinear edges (rank 1, 11 nodes): |R v - u| {res['rv_err']:.2e}, |det R - 1| {res['det_err']:.2e}, "
          f"|R R^T - I| {res['orth_err']:.2e}")
    if not (res["identity"] and max(res["rv_err"], res["det_err"], res["orth_err"]) <= ROTFIT_TOL):
        raise RuntimeError(f"{tag} estimate_rotations on planted edge sets: {res}")
    return res


def prime_sync_debug():
    """Switch the sync debug mode on and off once, unaudited: the first
    switch in a process is itself flagged once (torch 2.11), at
    set_sync_debug_mode's own line, with no copy and no synchronization."""
    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)


class SyncCounter:
    """Synchronizing operations between ``start()`` and ``stop()`` under
    torch.cuda.set_sync_debug_mode("warn") and the profiler: by source line
    ({"file:line": count}), the innermost line of this repository that led
    to each, and the device-to-host copies and stream synchronizations."""

    def start(self):
        import collections

        import torch
        from torch.profiler import ProfilerActivity, profile

        self.sites, self.callers = collections.Counter(), {}
        prime_sync_debug()
        torch.cuda.synchronize()
        self._warn = warnings.catch_warnings()
        self._warn.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._seen
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.set_sync_debug_mode("warn")

    def _seen(self, message, category, filename, lineno, *a, **k):
        import traceback

        if "synchroniz" not in str(message):
            return
        key = f"{Path(filename).name}:{lineno}"
        self.sites[key] += 1
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if "riggs_tpu_torch" in f.filename] or stack[-3:]
        self.callers[key] = " < ".join(f"{Path(f.filename).name}:{f.lineno} {f.line}" for f in ours[-1:] + stack[-2:-1])

    def stop(self):
        """Returns (sites, callers, copies, synchronizations)."""
        import torch

        try:
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        finally:
            self._prof.__exit__(None, None, None)
            self._warn.__exit__(None, None, None)
        events = self._prof.key_averages()
        dtoh = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA and "DtoH" in e.key)
        # a host read is a copy and a stream synchronize (the profile's own
        # synchronize after the call is a device synchronize)
        syncs = sum(e.count for e in events if e.key == "cudaStreamSynchronize")
        return dict(self.sites), self.callers, dtoh, syncs


def count_syncs(fn):
    """One call of ``fn`` (warmed up by the caller) under a SyncCounter.
    Returns (sites, callers, copies, synchronizations, fn's result)."""
    counter = SyncCounter()
    counter.start()
    try:
        out = fn()
    finally:
        res = counter.stop()
    return (*res, out)


def sync_audit(label, fn, expected=None):
    """count_syncs of one call of ``fn``: ``expected`` ({"file:line":
    count}, none by default) must match exactly, and the copies and
    synchronizations its total. Then, where none is expected, one more call
    in "error" mode, in which any synchronizing operation raises. Prints one
    [sync] line; returns fn's last result."""
    import torch

    expected = expected or {}
    sites, callers, dtoh, syncs, out = count_syncs(fn)
    total = sum(expected.values())
    found = {k: (v, callers.get(k, "")) for k, v in sites.items()}
    print(f"[sync] {label}: {dtoh} device-to-host copies, {syncs} stream synchronizations, "
          f"{sum(sites.values())} synchronizing operations {found or ''} (expected {expected or 'none'})")
    if sites != expected or dtoh != total or syncs != total:
        raise RuntimeError(f"[sync] {label}: synchronizing operations {found}, {dtoh} copies, {syncs} syncs; "
                           f"expected {expected or 'none'}")
    if not expected:
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out


def build_loop_scene(gs, skel):
    """The [loop] scene: LOOP_FRAMES train frames at SIZE x SIZE, the avatar
    posed by its own skeleton at times i / LOOP_FRAMES seen from cameras on
    an arc about its front, on a white background; alpha masks from the
    render's acc, the thinned 2D skeleton of each mask (thin_mask_skeleton),
    the point cloud the avatar's alive means and colours, cameras_extent by
    compute_scene_extent; and two test frames, each halfway between two
    train frames in time and on the arc."""
    import torch

    from riggs_tpu_torch.camera import make_camera
    from riggs_tpu_torch.data.dataset import Frame, SceneData, pad_thinned, thin_mask_skeleton
    from riggs_tpu_torch.ops.sh import C0
    from riggs_tpu_torch.train.static import compute_scene_extent

    t0 = time.perf_counter()
    white = torch.ones(3, device=DEVICE)

    def arc_camera(a):
        # the [scene] camera swung about the avatar's vertical axis
        R = np.array([[np.cos(a), 0.0, -np.sin(a)], [0.0, -1.0, 0.0], [-np.sin(a), 0.0, -np.cos(a)]])
        center = np.array([2.6 * np.sin(a), 0.15, 2.6 * np.cos(a)])
        return make_camera(R, -R.T @ center, SIZE, SIZE, fovx=0.8, fovy=0.8, device=DEVICE)

    angles = np.radians(np.linspace(-LOOP_ARC_DEG, LOOP_ARC_DEG, LOOP_FRAMES))
    cams = [arc_camera(a) for a in angles]
    frames, thin_s, n_thin, max_count = [], 0.0, [], 0
    for i, cam in enumerate(cams):
        t = i / LOOP_FRAMES
        out = frame(gs, skel, cam, white, t=t, max_per_tile=16384)
        _check_frame(out, SIZE, f"loop scene frame {i}")
        max_count = max(max_count, int(out["max_count"]))
        alpha = out["alpha"]
        t1 = time.perf_counter()
        pix = thin_mask_skeleton(alpha.cpu().numpy() > 0.5)
        thin_s += time.perf_counter() - t1
        n_thin.append(len(pix))
        tp, tm = pad_thinned(pix, N_THIN)
        frames.append(Frame(cam=dataclasses.replace(cam, fid=torch.tensor(t, device=DEVICE)), image=out["render"],
                            alpha_mask=alpha, thinned=torch.as_tensor(tp, device=DEVICE),
                            thinned_mask=torch.as_tensor(tm, device=DEVICE)))
    # the test frames: halfway between two train frames, in time and on the arc
    tests = []
    for i in LOOP_TEST_BETWEEN:
        t = (i + 0.5) / LOOP_FRAMES
        cam = arc_camera((angles[i] + angles[i + 1]) / 2)
        out = frame(gs, skel, cam, white, t=t, max_per_tile=16384)
        _check_frame(out, SIZE, f"loop scene test frame at t={t}")
        tests.append(Frame(cam=dataclasses.replace(cam, fid=torch.tensor(t, device=DEVICE)), image=out["render"]))
    n = int(gs.num_alive)
    cols = np.clip(gs.features_dc[:n, 0].cpu().numpy() * C0 + 0.5, 0.0, 1.0)
    scene = SceneData(gs.xyz[:n].cpu().numpy(), cols, is_blender=True, train_frames=frames, test_frames=tests,
                      cameras_extent=compute_scene_extent(cams), white_background=True)
    # the plain-window cap of phase B's probe steps: the frames' largest
    # tile count with headroom for the motion and for densification to full
    # capacity (the ladder, once fitted, sets its own caps)
    cap = int(-(-int(max_count * 1.25 * gs.capacity / n) // 128) * 128)
    print(f"[loop] scene: {LOOP_FRAMES} frames at {SIZE}x{SIZE} on white, {n} points; thinned skeleton pixels "
          f"{n_thin} ({thin_s:.1f} s of thinning); cameras_extent {scene.cameras_extent:.4f}; max tile count "
          f"{max_count} -> phase-B window {cap}; set-up {time.perf_counter() - t0:.1f} s")
    return scene, cap


def _phase_a_groups(g):
    """Parameter group -> gradient leaves of a phase-A gradient tree."""
    from riggs_tpu_torch.train.optim import tree_leaves

    out = {f"node_gs.{k}": [v] for k, v in g["node_gs"].items() if v.numel()}
    w = g["warp"]
    out.update({"warp.nodes_xyz": [w["nodes"][:, :3]], "warp.nodes_hyper": [w["nodes"][:, 3:]],
                "warp.radius": [w["radius"]], "warp.weight": [w["weight"]], "warp.mlp": tree_leaves(w["mlp"])})
    out["mean2d_bias"] = [g["m2b"]]
    return out


def _stage1_config(capacity):
    from riggs_tpu_torch.train.config import Config

    cfg = Config()
    cfg.model.capacity, cfg.model.sh_degree, cfg.model.gs_with_motion_mask = capacity, SH_DEGREE, True
    return cfg


def stage1_phase_a(blend, scene):
    """Phase 10: the phase-A step at full width: init_stage1 from the
    avatar's points (131072 slots, 512 nodes, 8192 node slots), the [loop]
    scene's first frame; make_phase_a_auto at PHASE_A_ITS with the counters
    zeroed just before and read just after; gradients finite and nonzero
    exactly where the toggles give one, kernel path against plain-version
    path; blend_cm and blend_cm_bwd against their plain versions on the
    node cloud's windows; step time, busy time and idle share; the sync
    audit. Returns (launch counts, forward, backward and rotation-fit kernel
    results)."""
    import torch

    from riggs_tpu_torch.ops import geometry as GEO
    from riggs_tpu_torch.train.optim import grad_tree, tree_leaves
    from riggs_tpu_torch.train.stage1 import Stage1Draws, init_stage1, make_phase_a_auto, phase_a_flags, phase_a_loss

    t0 = time.perf_counter()
    cfg = _stage1_config(CAPACITY)
    state0 = init_stage1(scene, cfg, generator=torch.Generator(device=DEVICE).manual_seed(2), device=DEVICE)
    fr, ti = scene.train_frames[0], scene.time_interval
    bg = torch.ones(3, device=DEVICE)
    step = make_phase_a_auto(cfg, ti)
    draws = Stage1Draws(5, DEVICE)
    kw = dict(max_per_tile=cfg.pipe.max_per_tile)
    torch.cuda.synchronize()
    print(f"[stage1] phase A: init_stage1 {time.perf_counter() - t0:.1f} s: {int(state0.node_gs.num_alive)} node "
          f"Gaussians of {state0.node_gs.capacity} (SH 0, shared isotropic scale), {state0.warp.node_num} nodes, "
          f"{int(state0.gs.num_alive)} Gaussians of {state0.gs.capacity}; window {kw['max_per_tile']}")

    def fresh(it):
        st = copy.deepcopy(state0)
        return dataclasses.replace(st, it=torch.tensor(it, dtype=torch.int32, device=DEVICE))

    # the main path: make_phase_a_auto steps, counters zeroed just before
    torch.cuda.synchronize()
    blend.reset_launches()
    GEO.reset_launches()
    for it in PHASE_A_ITS:
        st = fresh(it)
        for k in range(STAGE1_STEPS):
            st, m = step(st, fr, bg, draws.phase_a(fr.fid, ti), it=it + k, **kw)
            if not all(bool(torch.isfinite(v).all()) for v in m.values() if v.is_floating_point()):
                raise RuntimeError(f"[stage1] phase A it={it}: non-finite metric")
            if int(m["overflow_tiles"]) or int(m["overflow_rect"]):
                raise RuntimeError(f"[stage1] phase A it={it}: overflow {int(m['overflow_tiles'])}/"
                                   f"{int(m['overflow_rect'])}")
        leaves = tree_leaves(st.node_gs.params_dict()) + tree_leaves(st.warp.params_dict())
        if not all(bool(torch.isfinite(v).all()) for v in leaves) or int(st.it) != it + STAGE1_STEPS:
            raise RuntimeError(f"[stage1] phase A it={it}: non-finite parameters or wrong it")
        print(f"[stage1] phase A it={it} ({phase_a_flags(cfg, it)}): {STAGE1_STEPS} steps, loss "
              f"{float(m['loss']):.5f} psnr {float(m['psnr']):.2f}, no overflow")
    torch.cuda.synchronize()
    launches = dict(blend.launches, **GEO.launches)
    print(f"[stage1] phase A launch counters: {launches}")
    for name in ("blend_cm", "blend_cm_bwd", "estimate_rotations"):
        if launches[name] <= 0:
            raise RuntimeError(f"phase A never launched {name}")

    # gradients: finite, nonzero where the toggles give one, kernel vs plain path
    reg_t = draws.phase_a(fr.fid, ti)

    def frame_grads(it):
        st = fresh(it)
        params = {"node_gs": {k: v.detach().requires_grad_(True) for k, v in st.node_gs.params_dict().items()},
                  "warp": st.warp.params_dict(), "m2b": torch.zeros_like(st.node_gs.xyz[:, :2], requires_grad=True)}
        flags = {k: v for k, v in phase_a_flags(cfg, it).items()}
        loss, _ = phase_a_loss(params, st, fr, bg, params["m2b"], reg_t, ti, **flags, **kw)
        return loss, grad_tree(loss, params)

    # the node colours start black (SH 0, clamped at 0): no colour gradient;
    # the shared isotropic scale leaves the rotations at cancellation noise
    # (not checked); in the warm-up d_xyz is detached and the regularizers
    # are off, so nothing reaches the warp; the node positions reach no
    # regularizer (detached), the radii and weights the elastic term's
    # blend weights, the hyper coords nothing while they are all equal
    # (1e-2 at init: their distances' gradient is 0)
    live = {0: {"node_gs.xyz", "node_gs.scaling", "node_gs.opacity", "mean2d_bias"},
            PHASE_A_ITS[-1]: {"node_gs.xyz", "node_gs.scaling", "node_gs.opacity", "mean2d_bias", "warp.mlp",
                              "warp.radius", "warp.weight"}}
    for it in PHASE_A_ITS:
        loss, gk = frame_grads(it)
        if not bool(torch.isfinite(loss)):
            raise RuntimeError(f"[stage1] phase A it={it}: non-finite loss")
        for name, lv in _phase_a_groups(gk).items():
            if not all(bool(torch.isfinite(v).all()) for v in lv):
                raise RuntimeError(f"[stage1] phase A it={it}: non-finite gradient in {name}")
            if name == "node_gs.rotation":
                continue
            nonzero = any(bool(v.any()) for v in lv)
            if nonzero != (name in live[it]):
                raise RuntimeError(f"[stage1] phase A it={it}: gradient of {name} is "
                                   f"{'nonzero' if nonzero else 'zero'}, the toggles say otherwise")
        with _PlainBlend(blend):
            _, gp = frame_grads(it)
        compare_grads(gk, gp, f"phase A kernel vs plain-version path, it={it}", groups=_phase_a_groups,
                      tag="[stage1]")
        del gk, gp
    print(f"[stage1] phase A gradients finite and nonzero exactly where the toggles give one, at it {PHASE_A_ITS}")

    # blend_cm and blend_cm_bwd against their plain versions on a real step's inputs
    with _Capture(blend, ("blend_cm_fwd", "blend_cm_bwd")) as c, _RotCapture() as rc:
        step(fresh(PHASE_A_ITS[-1]), fr, bg, reg_t, it=PHASE_A_ITS[-1], **kw)
    fres = check_kernels(blend, {"blend_cm": c.calls["blend_cm_fwd"]}, tag="[stage1] phase A", per="step")
    bres = check_bwd_kernels(blend, {"blend_cm_bwd": c.calls["blend_cm_bwd"]}, tag="[stage1] phase A")
    rres = check_rotfit(rc.fits, "[stage1] phase A")
    del c, rc

    # step time, the device's share of it, and the sync audit
    st = fresh(PHASE_A_ITS[-1])

    def one():
        nonlocal st
        st, _ = step(st, fr, bg, draws.phase_a(fr.fid, ti), it=PHASE_A_ITS[-1], **kw)

    one()  # warm-up
    ms = _host_ms(one, 5)
    busy = _profile_busy(one, 5)
    print(f"[stage1] phase A: step {ms:.2f} ms (host clock, synchronized, it={PHASE_A_ITS[-1]}, {SIZE}x{SIZE}); "
          f"device busy {busy:.2f} ms (idle share {1 - busy / ms:.3f})")
    sync_audit(f"make_phase_a_auto (it={PHASE_A_ITS[-1]})", one)
    return launches, fres, bres, rres


def _profile_busy(fn, n):
    """The device's busy ms per call of fn over n calls (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in _device_ops(prof.key_averages())) / 1e3 / n
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time")
    return busy


class _LoopProbe:
    """A training loop's step_callback: stamps the host clock after every
    step (no synchronize: the loop's own pace), profiles the device over
    steps [start, start + 5) of each phase (``profile_from``: phase ->
    start), and keeps the blend wrappers' arguments and the ARAP fit's
    covariances of the ``held`` steps ((phase, it) -> label; every other
    step's are dropped at its end). While it is entered, each
    make_phase_b_auto step runs a held phase-B step as a step of its own
    (eager: the loop's may replay a CUDA graph, whose launches Python does
    not see) and keeps every phase-B step's metrics (``b_metrics``);
    ``replays`` counts the loop's replayed phase-B steps, ``unseen`` those
    that ran no Python (a capture records its step in Python, then replays
    it)."""

    def __init__(self, blend, held=LOOP_HELD, profile_from=None):
        self.capture = _Capture(blend, ("blend_cm_fwd", "blend_cm_bwd", "blend_permuted_gm_fwd",
                                        "blend_permuted_gm_bwd"))
        self.rot = _RotCapture()
        self.held_keys, self.profile_from = held, profile_from or {"A": PROFILE_FROM, "B": PROFILE_FROM}
        self.stamps = {p: [] for p in self.profile_from}
        self.busy, self.held, self.held_rot = {}, {}, {}
        self.b_steps, self.b_metrics = [], []

    def __enter__(self):
        from riggs_tpu_torch.train import stage1 as S1

        self.capture.__enter__()
        self.rot.__enter__()
        self.S1, self.real_b = S1, S1.make_phase_b_auto

        def auto(*a, **k):
            step = self.real_b(*a, **k)
            self.b_steps.append(step)

            def run(*sa, it, **sk):
                own = ("B", it) in self.held_keys
                state, metrics = (self.real_b(*a, **k) if own else step)(*sa, it=it, **sk)
                self.b_metrics.append(metrics)
                return state, metrics
            return run

        S1.make_phase_b_auto = auto
        return self

    def __exit__(self, *exc):
        self.S1.make_phase_b_auto = self.real_b
        self.rot.__exit__(*exc)
        self.capture.__exit__(*exc)

    @property
    def replays(self):
        return sum(step.graphs.replays for step in self.b_steps)

    @property
    def unseen(self):
        return self.replays - sum(step.graphs.captures for step in self.b_steps)

    def __call__(self, state, it, phase):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.stamps[phase].append((it, time.perf_counter()))
        if (phase, it) in self.held_keys:
            self.held[phase, it] = {k: list(v) for k, v in self.capture.calls.items()}
            self.held_rot[phase, it] = list(self.rot.fits)
        for v in self.capture.calls.values():
            v.clear()
        self.rot.fits.clear()
        start = self.profile_from[phase]
        if it == start - 1:
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
        elif it == start + 4:
            torch.cuda.synchronize()
            self.prof.stop()
            self.busy[phase] = sum(e.self_device_time_total for e in _device_ops(self.prof.key_averages())) / 1e3 / 5
            del self.prof

    def ms(self, phase, since=0):
        """(median, mean) host ms between consecutive step ends of a phase
        from step ``since`` on, the profiled window's steps and the one after
        (the profile's read) left out."""
        st, start = self.stamps[phase], self.profile_from[phase]
        d = [(b - a) * 1e3 for (_, a), (it, b) in zip(st, st[1:]) if not start <= it <= start + 5 and it >= since]
        return float(np.median(d)), float(np.mean(d))


def check_loop_kernels(blend, held, labels=LOOP_HELD, want=None, tag="[loop]"):
    """The four kernels of a loop held to their plain versions on the held
    steps' own inputs (``labels``: (phase, it) -> label; ``want``: kernel
    -> the labels it must be held on; the loop's by default: phase A's and
    the probe step's plain windows at the loop's cap, the last step's
    ladder buckets). Returns {kernel: {label: result}}."""
    want = want or {"blend_cm": ("phase A it=25", "phase B probe it=0"), "blend_permuted_gm": ("phase B ladder it=39",)}
    out = {k: {} for k in ("blend_cm", "blend_permuted_gm", "blend_cm_bwd", "blend_permuted_gm_bwd")}
    for key, label in labels.items():
        calls = held[key]
        for name in ("blend_cm", "blend_permuted_gm"):
            if not calls[f"{name}_fwd"]:
                continue
            t = f"{tag} {label}"
            out[name][label] = check_kernels(blend, {name: calls[f"{name}_fwd"]}, tag=t, per="step")[name]
            out[f"{name}_bwd"][label] = check_bwd_kernels(blend, {f"{name}_bwd": calls[f"{name}_bwd"]},
                                                          tag=t)[f"{name}_bwd"]
    for name, labels_ in want.items():
        for n in (name, f"{name}_bwd"):
            if sorted(out[n]) != sorted(labels_):
                raise RuntimeError(f"{tag} {n} was held on {sorted(out[n])}, not on {sorted(labels_)}")
    return out


def loop_phase(blend, scene, cap):
    """Phase 11: a short train_stage1 on the [loop] scene at full width
    (LOOP_SCHEDULE cuts only the schedule), with the counters zeroed just
    before and read just after. Prints the events, the node counts, the
    ladder's refits, loss and PSNR at both ends of both phases, ms per step
    of each phase by host clock and the device's busy time and idle share
    over 5 steps of each; then holds the four kernels and the rotation fit
    to their plain versions on the LOOP_HELD steps' inputs. Returns the
    launch counts, the blend and rotation-fit results, the trained state and
    phase B's median ms per step."""
    import torch

    from riggs_tpu_torch.ops import geometry as GEO
    from riggs_tpu_torch.train.optim import tree_leaves
    from riggs_tpu_torch.train.stage1 import train_stage1

    cfg = _stage1_config(CAPACITY)
    for k, v in LOOP_SCHEDULE.items():
        setattr(cfg.pipe if k == "ladder_check_every" else cfg.opt, k, v)
    cfg.pipe.max_per_tile = cap  # phase A's node cloud fits any window; phase B's probe steps need this one
    events = []
    torch.cuda.synchronize()
    blend.reset_launches()
    GEO.reset_launches()
    t0 = time.perf_counter()
    with _LoopProbe(blend) as probe:
        state, hist = train_stage1(scene, cfg, seed=0, log_every=LOOP_SCHEDULE["iterations"] - 1, events=events,
                                   step_callback=probe, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(blend.launches, **GEO.launches)
    for e in events:
        print(f"[loop] event {e}")
    for p, it, m in hist:
        print(f"[loop] {p} it={it}: loss {m['loss']:.5f} psnr {m['psnr']:.2f}")
    for p in ("A", "B"):
        med, mean = probe.ms(p)
        busy = probe.busy[p]
        print(f"[loop] phase {p}: {len(probe.stamps[p])} steps, {med:.2f} ms per step (host clock, median; mean "
              f"{mean:.2f} with the events), device busy {busy:.2f} ms per step over steps "
              f"{PROFILE_FROM}-{PROFILE_FROM + 4} (idle share {1 - busy / med:.3f})")
    print(f"[loop] train_stage1 {wall:.1f} s; launch counters: {launches}")
    kinds = {e["event"] for e in events}
    for want in ("node_gs densify", "node sampling", "node densify/prune", "gs densify", "opacity reset",
                 "ladder fit"):
        if want not in kinds:
            raise RuntimeError(f"[loop] no {want} event")
    final = [e for e in events if e["event"] == "ladder"][-1]
    if final["refits"] < 1:
        raise RuntimeError("[loop] the ladder was never refitted")
    sampled = [e for e in events if e["event"] == "node sampling"][0]
    if sampled["after"] != cfg.model.node_num or sampled["nodes"] != cfg.model.node_num:
        raise RuntimeError(f"[loop] node sampling kept {sampled['after']} node Gaussians, {sampled['nodes']} nodes")
    if not [e for e in events if e["event"] == "gs densify" and e["after"] != e["before"]]:
        raise RuntimeError("[loop] no Gaussian densification changed the alive count")
    refit_at = {e["it"] for e in events if e["event"] in ("ladder refit", "ladder fit")}
    late = [e for e in events if e["event"] == "overflow"]
    bad = [e for e in late if e["phase"] == "A" or e["rect"] or e["it"] not in refit_at]
    if bad:
        raise RuntimeError(f"[loop] steps overflowed without the ladder reacting: {bad}")
    print(f"[loop] overflow: {len(late)} step(s), each answered by a ladder refit one step late: {late}")
    leaves = (tree_leaves(state.gs.params_dict()) + tree_leaves(state.node_gs.params_dict())
              + tree_leaves(state.warp.params_dict()))
    if not all(bool(torch.isfinite(v).all()) for v in leaves):
        raise RuntimeError("[loop] non-finite parameters")
    for name in ("blend_cm", "blend_cm_bwd", "blend_permuted_gm", "blend_permuted_gm_bwd", "estimate_rotations"):
        if launches[name] <= 0:
            raise RuntimeError(f"the loop never launched {name}")
    # a replayed phase-B step launches its rotation fit from the graph, unseen by the counter
    n_steps = sum(len(v) for v in probe.stamps.values())
    if launches["estimate_rotations"] != n_steps - probe.unseen or launches["fit_rotations"]:
        raise RuntimeError(f"[loop] not one fused rotation fit a step over {n_steps} steps, {probe.unseen} of "
                           f"them replays that ran no Python: {launches}")
    print(f"[loop] phase B: {probe.replays} of {len(probe.stamps['B'])} steps replayed a CUDA graph")
    print(f"[loop] {state.warp.node_num} nodes, {int(state.gs.num_alive)} Gaussians of {state.gs.capacity}, "
          f"every parameter finite; refits {final['refits']}, ladder {final['ladder']}")
    if sorted(probe.held) != sorted(LOOP_HELD):
        raise RuntimeError(f"[loop] held the blend calls of steps {sorted(probe.held)}, not {sorted(LOOP_HELD)}")
    held, held_rot, b_ms = probe.held, probe.held_rot, probe.ms("B")[0]
    del probe
    rot = {label: check_rotfit(held_rot[key], f"[loop] {label}") for key, label in LOOP_HELD.items()}
    return launches, check_loop_kernels(blend, held), rot, state, b_ms


class _PipelineProbe(_LoopProbe):
    """train_stage2's step_callback for [pipeline]: _LoopProbe's stamps,
    profiles and held calls by phase ("W" the warm-up, "M" the main phase);
    the SyncCounter over PIPE_SYNC_STEP (from the end of the step before it
    to its own end); and the step metrics of the ends of both phases,
    caught from make_stage2_auto's step."""

    def __init__(self, blend, warm_up, n_steps):
        super().__init__(blend, held=PIPE_HELD, profile_from=PIPE_PROFILE_FROM)
        self.warm_up, self.keep = warm_up, {0, warm_up - 1, warm_up, n_steps - 1}
        self.metrics, self.syncs = {}, None

    def __enter__(self):
        from riggs_tpu_torch.train import stage2 as S2

        super().__enter__()
        self.S2, self.real_auto = S2, S2.make_stage2_auto

        def auto(*a, **k):
            step = self.step = self.real_auto(*a, **k)

            def run(*sa, it, **sk):
                # a held step's blend calls are caught in Python: a step of
                # its own runs it eagerly (the loop's may replay a graph)
                held = ("W" if it < self.warm_up else "M", it) in self.held_keys
                state, metrics = (self.real_auto(*a, **k) if held else step)(*sa, it=it, **sk)
                if it in self.keep:
                    self.metrics[it] = metrics
                return state, metrics
            return run

        S2.make_stage2_auto = auto
        return self

    def __exit__(self, *exc):
        self.S2.make_stage2_auto = self.real_auto
        super().__exit__(*exc)

    def __call__(self, state, it):
        if it == PIPE_SYNC_STEP:
            self.syncs = self.counter.stop()
        super().__call__(state, it, "W" if it < self.warm_up else "M")
        if it == PIPE_SYNC_STEP - 1:
            self.counter = SyncCounter()
            self.counter.start()


def _stage2_config(cap):
    cfg = _stage1_config(CAPACITY)
    cfg.model.use_skinning_weight_mlp = cfg.model.use_template_offsets = True
    for k, v in STAGE2_SCHEDULE.items():
        setattr(cfg.pipe if k == "ladder_check_every" else cfg.opt, k, v)
    cfg.pipe.max_per_tile = cap  # the probe steps' plain window (the ladder, once fitted, sets its own caps)
    return cfg


def pipeline_phase(blend, scene, cap, stage1_state):
    """Phase 12: from the [loop]'s trained stage-1 state, init_stage2
    (precompute_deformations over the loop's frames, skeleton extraction
    from up to 200 of its nodes, the template bake, the 8x256 MLPs) and a
    train_stage2 of STAGE2_SCHEDULE (only the schedule cut) with its test
    evaluation on the two test frames, the counters zeroed just before and
    read just after. Prints the skeleton, the bake, the extraction's host
    time, the events, loss and PSNR at both ends of both phases, the test
    metrics, ms per step of each phase and the device's busy time and idle
    share over 5 steps of each, and the host reads of one step with no
    event (the one late copy of the overflow counters); then holds the four
    kernels to their plain versions on the PIPE_HELD steps' inputs. Returns
    the launch counts and those results."""
    import torch

    from riggs_tpu_torch.ops import geometry as GEO
    from riggs_tpu_torch.train import stage1 as S1
    from riggs_tpu_torch.train import stage2 as S2
    from riggs_tpu_torch.train.optim import tree_leaves

    cfg = _stage2_config(cap)
    o = cfg.opt
    timed = {}
    real_extract, real_init = S2.obtain_skeleton_tree, S2.init_stage2

    def extract(*a, **k):
        t = time.perf_counter()
        out = real_extract(*a, **k)
        timed["extract"] = time.perf_counter() - t
        return out

    def init(*a, **k):
        t = time.perf_counter()
        out = real_init(*a, **k)
        torch.cuda.synchronize()
        timed["init"] = time.perf_counter() - t
        return out

    events = []
    torch.cuda.synchronize()
    blend.reset_launches()
    GEO.reset_launches()
    t0 = time.perf_counter()
    S2.obtain_skeleton_tree, S2.init_stage2 = extract, init
    try:
        with warnings.catch_warnings(record=True) as caught, \
                _PipelineProbe(blend, o.skeleton_warm_up, o.iterations_stage2) as probe:
            warnings.simplefilter("always")
            state, info, _ = S2.train_stage2(stage1_state, scene, cfg, seed=0, test_every=PIPE_TEST_EVERY,
                                             events=events, step_callback=probe, device=DEVICE)
    finally:
        S2.obtain_skeleton_tree, S2.init_stage2 = real_extract, real_init
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(blend.launches, **GEO.launches)
    for w in caught:
        if "capacity limits" in str(w.message):
            raise RuntimeError(f"[pipeline] eval_image truncated a test frame: {w.message}")
    template = float(info.d_xyz[info.template_idx].abs().max())
    print(f"[pipeline] init_stage2 {timed['init']:.1f} s (skeleton extraction {timed['extract']:.2f} s on the host) "
          f"from {stage1_state.warp.node_num} nodes (at most {o.skeleton_max_candidates} candidates), "
          f"{int(state.gs.num_alive)} Gaussians of {state.gs.capacity}: J = {len(info.joints)}, parents "
          f"{info.parents.tolist()}, template frame {info.template_idx}, joint nodes "
          f"{info.joint_node_indices.tolist()}; baked template max |d_xyz| {template:.3e}")
    if not template <= 1e-5 or len(info.joints) < 2:
        raise RuntimeError(f"[pipeline] the template bake left max |d_xyz| {template} or J = {len(info.joints)}")
    for e in events:
        print(f"[pipeline] event " + str({k: (v.shape if isinstance(v, torch.Tensor) else v) for k, v in e.items()}))
    for it in sorted(probe.metrics):
        m = probe.metrics[it]
        print(f"[pipeline] it={it} ({'warm-up' if it < o.skeleton_warm_up else 'main'}): loss {float(m['loss']):.5f} "
              f"psnr {float(m['psnr']):.2f}")
    for p, name in (("W", "warm-up"), ("M", "main")):
        med, mean = probe.ms(p)
        busy = probe.busy[p]
        print(f"[pipeline] {name}: {len(probe.stamps[p])} steps, {med:.2f} ms per step (host clock, median; mean "
              f"{mean:.2f} with the events), device busy {busy:.2f} ms per step over steps "
              f"{PIPE_PROFILE_FROM[p]}-{PIPE_PROFILE_FROM[p] + 4} (idle share {1 - busy / med:.3f})")
    print(f"[pipeline] train_stage2 {wall:.1f} s with init_stage2; launch counters: {launches}")
    g = probe.step.graphs
    pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if g.pool is not None and tuple(seg.get("segment_pool_id", ())) == tuple(g.pool))
    print(f"[pipeline] the step's CUDA graphs over {o.iterations_stage2} steps: {g.eager} eager calls, "
          f"{g.captures} captures, {g.replays} replays (a share of {g.replays / o.iterations_stage2:.3f}; the "
          f"{len(PIPE_HELD)} held steps ran a step of their own), {len(g.graphs)} graphs kept of {len(g.seen)} keys; "
          f"the graphs' pool {pool / 2**20:.1f} MiB, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    if len(g.graphs) > 4:
        raise RuntimeError(f"[pipeline] {len(g.graphs)} graphs kept")
    kinds = {e["event"] for e in events}
    for want in ("fps reset", "gs densify", "ladder fit", "test"):
        if want not in kinds:
            raise RuntimeError(f"[pipeline] no {want} event")
    if [e["it"] for e in events if e["event"] == "fps reset"] != [o.optimize_template_offsets_iters]:
        raise RuntimeError("[pipeline] the FPS reset did not fire at the unlock")
    if not [e for e in events if e["event"] == "gs densify" and e["after"] != e["before"]]:
        raise RuntimeError("[pipeline] no Gaussian densification changed the alive count")
    final = [e for e in events if e["event"] == "ladder"][-1]
    if final["refits"] < 1:
        raise RuntimeError("[pipeline] the ladder was never refitted")
    refit_at = {e["it"] for e in events if e["event"] in ("ladder refit", "ladder fit")}
    late = [e for e in events if e["event"] == "overflow"]
    bad = [e for e in late if e["rect"] or e["it"] not in refit_at]
    if bad:
        raise RuntimeError(f"[pipeline] steps overflowed without the ladder reacting: {bad}")
    test = [e for e in events if e["event"] == "test"][0]
    if not all(np.isfinite(test[k]) for k in ("psnr", "ssim", "ms_ssim")):
        raise RuntimeError(f"[pipeline] non-finite test metrics {test}")
    print(f"[pipeline] test at it={test['it']} on {len(scene.test_frames)} frames: psnr {test['psnr']:.3f} ssim "
          f"{test['ssim']:.4f} ms_ssim {test['ms_ssim']:.4f}; overflow answered by a refit one step late: {late}")
    sites, callers, dtoh, syncs = probe.syncs
    expected = {_site(S1._overflow, "tolist"): 1}
    print(f"[sync] train_stage2 step {PIPE_SYNC_STEP} (no event): {dtoh} device-to-host copies, {syncs} stream "
          f"synchronizations, synchronizing operations {({k: (v, callers.get(k, '')) for k, v in sites.items()})} "
          f"(expected {expected}: the previous step's overflow counters)")
    if sites != expected or dtoh != 1 or syncs != 1:
        raise RuntimeError(f"[sync] train_stage2 step {PIPE_SYNC_STEP}: {sites}, {dtoh} copies, {syncs} syncs; "
                           f"expected {expected}")
    leaves = tree_leaves(state.gs.params_dict()) + tree_leaves(state.skel.params_dict())
    if not all(bool(torch.isfinite(v).all()) for v in leaves):
        raise RuntimeError("[pipeline] non-finite parameters")
    for name in ("blend_cm", "blend_cm_bwd", "blend_permuted_gm", "blend_permuted_gm_bwd"):
        if launches[name] <= 0:
            raise RuntimeError(f"the pipeline never launched {name}")
    print(f"[pipeline] {int(state.gs.num_alive)} Gaussians of {state.gs.capacity}, J = {state.skel.net.n_joints}, "
          f"every parameter finite; refits {final['refits']}, ladder {final['ladder']}")
    if sorted(probe.held) != sorted(PIPE_HELD):
        raise RuntimeError(f"[pipeline] held the blend calls of steps {sorted(probe.held)}, not {sorted(PIPE_HELD)}")
    held = probe.held
    del probe
    want = {"blend_cm": ("warm-up probe it=5",), "blend_permuted_gm": ("after the FPS reset it=40", "ladder it=59")}
    return launches, check_loop_kernels(blend, held, PIPE_HELD, want, tag="[pipeline]"), state, info, cfg


def _same_leaves(a, b):
    """Keys of two states' leaf tables whose tensors differ in any bit."""
    import torch

    from riggs_tpu_torch.io.checkpoint import state_leaves

    la, lb = state_leaves(a), state_leaves(b)
    if set(la) != set(lb):
        return sorted(set(la) ^ set(lb))
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return [k for k in la if la[k][0].shape != lb[k][0].shape or not torch.equal(bits(la[k][0]), bits(lb[k][0]))]


class _Recorder:
    """A TrainLogger stand-in that keeps every scalars call."""

    def __init__(self):
        self.calls = []

    def scalars(self, step, prefix, values):
        self.calls.append((step, prefix, sorted(values)))


def io_phase(blend, scene, stage1_state, state, info, cfg):
    """Phase 13, on [pipeline]'s trained rig at full width: save it (state
    .npz, PLY, skeleton tree, OBJ, cfg.json), load it back into a fresh
    init_stage2 template (every leaf bitwise) and the PLY (the alive
    Gaussians bitwise); resume train_stage2 from the checkpoint for
    IO_RESUME_STEPS steps with a recording logger, one test evaluation and
    one best-PSNR checkpoint; render_test_set on the two test frames with
    the skinning render and LPIPS alex and vgg from seeded files
    (scripts/make_lpips_ckpt.py), the card's LPIPS held to the CPU's, the
    per-frame overflow counters, host reads and times; then the forward
    blend calls of one test frame and its skinning render held to their
    plain versions. The launch counters are zeroed just before the resume
    and read after the test set. Returns (launches, the held forward's
    results)."""
    import tempfile

    import torch

    from riggs_tpu_torch.eval import synthesis as SYN
    from riggs_tpu_torch.eval.metrics import LpipsModel
    from riggs_tpu_torch.io import checkpoint as CK
    from riggs_tpu_torch.io.obj import read_skeleton_obj, write_skeleton_obj
    from riggs_tpu_torch.io.ply import load_gaussians_ply
    from riggs_tpu_torch.ops import geometry as GEO
    from riggs_tpu_torch.train import stage2 as S2

    with tempfile.TemporaryDirectory() as tmp:
        rig, saved_at = Path(tmp) / "rig", cfg.opt.iterations_stage2
        # 1. save and load back
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CK.save_checkpoint(rig, saved_at, state, gs=state.gs, cfg=cfg)
        CK.save_skeleton_tree(rig, info.joints, info.parents, info.joint_node_indices, info.template_idx)
        write_skeleton_obj(rig / "skeleton.obj", info.joints, info.parents)
        save_s = time.perf_counter() - t0
        sizes = {str(f.relative_to(rig)): f.stat().st_size for f in sorted(rig.rglob("*")) if f.is_file()}
        template, _, _ = S2.init_stage2(stage1_state, scene, cfg, generator=torch.Generator(device=DEVICE).manual_seed(1),
                                        device=DEVICE)
        if not _same_leaves(template, state):
            raise RuntimeError("[io] the fresh template already equals the trained state")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded, it = CK.load_checkpoint(rig, template)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gs_ply = load_gaussians_ply(rig / "point_cloud" / f"iteration_{saved_at}" / "point_cloud.ply",
                                    capacity=state.gs.capacity, max_sh_degree=state.gs.max_sh_degree,
                                    isotropic=state.gs.isotropic, with_motion_mask=state.gs.with_motion_mask,
                                    device=DEVICE)
        torch.cuda.synchronize()
        ply_s = time.perf_counter() - t0
        differ = _same_leaves(loaded, state)
        n = int(state.gs.num_alive)
        alive = state.gs.alive
        ply_bad = [f for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "feature")
                   if not _same_bits(getattr(gs_ply, f)[:n], getattr(state.gs, f)[alive])]
        joints, edges = read_skeleton_obj(rig / "skeleton.obj")
        print(f"[io] saved the rig at iteration {saved_at} in {save_s:.2f} s, files (bytes) {sizes}; loaded back into a "
              f"fresh init_stage2 template in {load_s:.2f} s ({len(CK.state_leaves(loaded))} leaves, "
              f"{len(differ)} differing in any bit), the PLY in {ply_s:.2f} s ({n} alive Gaussians, fields differing "
              f"{ply_bad}); skeleton.obj {len(joints)} joints, {len(edges)} bones")
        if it != saved_at or differ or ply_bad or int(gs_ply.num_alive) != n or len(joints) != len(info.joints):
            raise RuntimeError(f"[io] the saved rig did not load back: iteration {it}, leaves {differ[:5]}, PLY {ply_bad}")
        del loaded, template, gs_ply

        # 2. resume train_stage2 from the checkpoint
        cfg_r = copy.deepcopy(cfg)
        cfg_r.opt.iterations_stage2 = saved_at + IO_RESUME_STEPS
        logger, events, stamps = _Recorder(), [], []
        torch.cuda.synchronize()
        blend.reset_launches()
        GEO.reset_launches()
        t0 = time.perf_counter()
        resumed, _, _ = S2.train_stage2(stage1_state, scene, cfg_r, seed=0, log_every=IO_LOG_EVERY, test_every=IO_TEST_AT,
                                        model_path=rig, logger=logger, resume=True, events=events,
                                        step_callback=lambda st, i: stamps.append((i, time.perf_counter())),
                                        device=DEVICE)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        kinds = [(e["it"], e["event"]) for e in events]
        steps = [i for i, _ in stamps]
        newest = CK.search_max_iteration(rig / "checkpoints")
        want_logs = [(i, "train_skeleton") for i in range(saved_at, saved_at + IO_RESUME_STEPS)
                     if i % IO_LOG_EVERY == 0]
        want_logs.insert([i for i, _ in want_logs].index(IO_TEST_AT) + 1, (IO_TEST_AT, "test"))
        step_ms = [(b - a) * 1e3 for (i, a), (j, b) in zip(stamps, stamps[1:])
                   if j not in (IO_TEST_AT, saved_at + 12) and j % IO_LOG_EVERY]  # no event, no log
        print(f"[io] resumed train_stage2: events {kinds}; steps {steps[0]}-{steps[-1]}, {np.median(step_ms):.2f} ms a "
              f"step with no event (host clock, median of {len(step_ms)}), {resume_s:.1f} s with init_stage2; logger "
              f"calls {[(i, p) for i, p, _ in logger.calls]} ({len(logger.calls[0][2])} train_skeleton scalars); "
              f"newest checkpoint iteration_{newest}")
        test = [e for e in events if e["event"] == "test"]
        if (kinds[0] != (saved_at, "resume") or steps != list(range(saved_at, saved_at + IO_RESUME_STEPS))
                or [(i, p) for i, p, _ in logger.calls] != want_logs or len(test) != 1
                or [e["it"] for e in events if e["event"] == "checkpoint"] != [IO_TEST_AT] or newest != IO_TEST_AT
                or not [e for e in events if e["event"] in ("ladder fit", "ladder refit")]):
            raise RuntimeError(f"[io] the resumed loop: events {kinds}, steps {steps}, logger {logger.calls}, "
                               f"newest {newest}")
        if not all(np.isfinite(test[0][k]) for k in ("psnr", "ssim", "ms_ssim")):
            raise RuntimeError(f"[io] non-finite test metrics {test[0]}")

        # 3. the test-set report with the skinning render and LPIPS
        lp_dir = Path(tmp) / "lpips"
        subprocess.run([sys.executable, str(Path(__file__).resolve().parent / "scripts" / "make_lpips_ckpt.py"),
                        "--out", str(lp_dir)], check=True, capture_output=True, text=True, timeout=300)
        frames = scene.test_frames
        bg = torch.ones(3, device=DEVICE) if scene.white_background else torch.zeros(3, device=DEVICE)
        real_rr, outs = SYN.render_rigged, []

        def rec_rr(*a, **k):
            out = real_rr(*a, **k)
            outs.append(out)
            return out

        rows = {}
        SYN.render_rigged = rec_rr
        try:
            for net in ("alex", "vgg"):
                lp = LpipsModel.from_torch_file(lp_dir / f"{net}_backbone.pth", lp_dir / f"{net}.pth", net=net,
                                                device=DEVICE)
                rows[net], _, images = SYN.render_test_set(resumed.gs, resumed.skel, frames, bg=bg, lpips_model=lp,
                                                           max_per_tile=cfg.pipe.max_per_tile)
                lp_cpu = LpipsModel.from_torch_file(lp_dir / f"{net}_backbone.pth", lp_dir / f"{net}.pth", net=net,
                                                    device="cpu")
                for i, (f, r) in enumerate(zip(frames, rows[net])):
                    ref = float(lp_cpu(torch.from_numpy(images[i]), f.image.cpu()))
                    rel = abs(r[f"lpips_{net}"] - ref) / abs(ref)
                    print(f"[io] frame {i} lpips_{net}: card {r[f'lpips_{net}']:.8f}, CPU {ref:.8f}, rel |d| {rel:.2e}")
                    if not rel <= LPIPS_REL_TOL:
                        raise RuntimeError(f"[io] lpips_{net} on the card {r} against the CPU's {ref}")
                img0 = torch.from_numpy(images[0]).to(DEVICE)
                lp_ms = _event_ms(lambda: lp(img0, frames[0].image), 10)
                print(f"[io] lpips_{net} {lp_ms:.3f} ms a frame (CUDA events, mean of 10 calls)")
        finally:
            SYN.render_rigged = real_rr
        torch.cuda.synchronize()
        launches = dict(blend.launches, **GEO.launches)
        of = [(int(o["overflow_tiles"]), int(o["overflow_rect"])) for o in outs]
        for net, rs in rows.items():
            for i, r in enumerate(rs):
                print(f"[io] render_test_set ({net}) frame {i}: " + " ".join(f"{k} {v:.6f}" for k, v in r.items()))
        print(f"[io] render_test_set overflow (tiles, rect) per frame: {of} (max_per_tile {cfg.pipe.max_per_tile}; "
              "the reference's report neither escalates nor reports them)")
        print(f"[io] launch counters over the resume and the test set: {launches}")
        for name in ("blend_cm", "blend_cm_bwd", "blend_permuted_gm", "blend_permuted_gm_bwd"):
            if launches[name] <= 0:
                raise RuntimeError(f"[io] never launched {name}")
        for rs in rows.values():
            if not all(np.isfinite(v) for r in rs for v in r.values()):
                raise RuntimeError(f"[io] non-finite test-set rows {rs}")
        lp = LpipsModel.from_torch_file(lp_dir / "alex_backbone.pth", lp_dir / "alex.pth", device=DEVICE)
        for vis in (True, False):
            run = lambda: SYN.render_test_set(resumed.gs, resumed.skel, frames, bg=bg, lpips_model=lp,
                                              with_skinning_vis=vis, max_per_tile=cfg.pipe.max_per_tile)
            run()
            sites, callers, dtoh, syncs, _ = count_syncs(run)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / (3 * len(frames)) * 1e3
            print(f"[io] render_test_set {'with' if vis else 'without'} the skinning render: {ms:.2f} ms a frame (host "
                  f"clock, 3 x {len(frames)} frames, with LPIPS alex); host reads a frame: {dtoh / len(frames):g} "
                  f"copies, {syncs / len(frames):g} synchronizations, sites "
                  f"{({k: (v, callers.get(k, '')) for k, v in sites.items()})}")
            if dtoh != 2 * len(frames):
                raise RuntimeError(f"[io] render_test_set read the card {dtoh} times for {len(frames)} frames")

    # 4. the forward blends of one test frame and its skinning render against their plain versions
    f = frames[0]
    with _Capture(blend) as cap_io:
        SYN.render_rigged(resumed.gs, resumed.skel, f.cam, t=f.fid, bg=bg, with_skinning_vis=True,
                          max_per_tile=cfg.pipe.max_per_tile)
    if len(cap_io.calls["blend_cm"]) != 2 or cap_io.calls["blend_permuted_gm"]:
        raise RuntimeError(f"[io] a test frame made {len(cap_io.calls['blend_cm'])} blend_cm calls, not 2")
    held = check_kernels(blend, {"blend_cm": cap_io.calls["blend_cm"]}, tag="[io] test frame 0 and its skinning render")
    return launches, held["blend_cm"]


def cli_phase():
    """Phase 16: scripts/torch_run_pipeline.py --synthetic as a process of
    its own on the card (CLI_RUN_SCHEDULE) with its viewer, SIBR and anomaly
    flags, a /render and a SIBR request served while it trains, then its rig/ loaded as
    scripts/torch_render_rig.py loads it and its test set rendered again:
    exit 0, every file scripts/run_pipeline.py writes, a finite
    numerical_res.txt equal to the reloaded rig's."""
    import importlib.util
    import tempfile

    import torch

    from riggs_tpu_torch.data.synthetic import make_scene_data
    from riggs_tpu_torch.eval.synthesis import format_numerical_res, render_test_set
    from riggs_tpu_torch.train.config import Config

    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "run"
        viewer_port, gui_port = _free_port(), _free_port()
        cmd = [sys.executable, str(root / "scripts" / "torch_run_pipeline.py"), "--synthetic", "--model_path", str(out),
               "--test_every", str(CLI_RUN_TEST_EVERY), "--viewer_port", str(viewer_port), "--gui_port", str(gui_port),
               "--detect_anomaly"]
        for k, v in CLI_RUN_SCHEDULE.items():
            cmd += [f"--{k}", str(v)]
        t0 = time.perf_counter()
        procs = _start([cmd])
        probes = {}
        threads = _pipeline_probes(gui_port, viewer_port, probes)
        (rc, stdout, stderr), = _finish(procs, 900)
        for th in threads:
            th.join(timeout=5)
        wall = time.perf_counter() - t0
        tail = [line for line in stdout.splitlines() if line.strip()][-4:]
        print(f"[cli] torch_run_pipeline.py --synthetic --viewer_port --gui_port --detect_anomaly exit {rc} in "
              f"{wall:.1f} s: {tail}")
        if rc != 0:
            raise RuntimeError(f"[cli] torch_run_pipeline.py failed:\n{stdout[-3000:]}\n{stderr[-3000:]}")
        sibr = probes.get("sibr")
        if probes.get("viewer") != (512, 512, 3) or sibr is None or sibr[:2] != ((64, 96, 3), str(out)):
            raise RuntimeError(f"[cli] while it trained: the live viewer's /render {probes.get('viewer')} (codes before "
                               f"it {probes.get('viewer_codes')}), the SIBR reply {sibr}")
        print(f"[cli] while it trained: the live viewer answered /render with a 512x512 PNG {probes['viewer_s']:.1f} s "
              f"after the start (earlier replies {probes.get('viewer_codes', [])}: 503 before the first step), a SIBR "
              f"request answered with a 96x64 image (mean {sibr[2]:.3f}) and the verify string; anomaly mode on "
              f"throughout")
        n = CLI_RUN_SCHEDULE["iterations"]
        want = ["cfg.json", "skeleton_tree.npz", "skeleton.obj", "numerical_res.txt",
                f"checkpoints/iteration_{n}/state.npz", f"point_cloud/iteration_{n}/point_cloud.ply",
                f"rig/checkpoints/iteration_{CLI_RUN_TEST_EVERY}/state.npz", f"rig/checkpoints/iteration_{n}/state.npz",
                f"rig/point_cloud/iteration_{n}/point_cloud.ply", "rig/cfg.json"]
        missing = [w for w in want if not (out / w).exists()]
        text = (out / "numerical_res.txt").read_text() if (out / "numerical_res.txt").exists() else ""
        vals = [float(x) for line in text.splitlines()[1:] for x in line.split("\t")[1:]]
        if missing or not vals or not all(np.isfinite(vals)):
            raise RuntimeError(f"[cli] missing {missing}; numerical_res.txt {text!r}")
        spec = importlib.util.spec_from_file_location("torch_render_rig", root / "scripts" / "torch_render_rig.py")
        rr = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(rr)
        cfg = Config.load(out / "cfg.json")
        _, scene = make_scene_data(n_train=16, n_test=4, width=128, height=128, device=DEVICE)
        state, it = rr.load_rig(out, cfg, scene, DEVICE)
        rows, means, _ = render_test_set(state.gs, state.skel, scene.test_frames, max_per_tile=cfg.pipe.max_per_tile)
        again = format_numerical_res(rows, means)
        print(f"[cli] rig/ reloaded at iteration {it} ({int(state.gs.num_alive)} Gaussians of {state.gs.capacity}, "
              f"J = {state.skel.net.n_joints}); test means {means}; numerical_res.txt reproduced: {again == text}")
        if it != n or again != text:
            raise RuntimeError(f"[cli] the reloaded rig (iteration {it}) gives\n{again}\nnot\n{text}")
        del state
        resume_cli(rr, out, cfg, scene)
        torch.cuda.synchronize()


def resume_cli(rr, out, cfg, scene):
    """scripts/torch_resume_stage2.py on [cli]'s output as a process of its
    own: its stage-1 checkpoint (its node set densified and pruned) read,
    stage 2 resumed from rig/'s checkpoint at CLI_RUN_SCHEDULE's length to
    RESUME_ITERATIONS; exit 0, the files it writes, and its rig reloaded."""
    root = Path(__file__).resolve().parent
    n = CLI_RUN_SCHEDULE["iterations"]
    for f in ("skeleton_tree.npz", "skeleton.obj", "numerical_res.txt"):
        (out / f).unlink()
    cmd = [sys.executable, str(root / "scripts" / "torch_resume_stage2.py"), "--model_path", str(out), "--iterations",
           str(RESUME_ITERATIONS), "--test_every", str(RESUME_ITERATIONS + 1), "--synthetic_size", "128",
           "--synthetic_frames", "16", "--synthetic_figure", "chain", "--synthetic_points", "120",
           "--synthetic_init_points", "300"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    tail = [line for line in res.stdout.splitlines() if line.strip()][-3:]
    print(f"[resume] torch_resume_stage2.py exit {res.returncode} in {wall:.1f} s: {tail}")
    if res.returncode != 0 or f"restored stage-1 state from iteration {n}" not in res.stdout:
        raise RuntimeError(f"[resume] torch_resume_stage2.py failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    want = ["skeleton_tree.npz", "skeleton.obj", "numerical_res.txt",
            f"rig/checkpoints/iteration_{RESUME_ITERATIONS}/state.npz",
            f"rig/point_cloud/iteration_{RESUME_ITERATIONS}/point_cloud.ply"]
    missing = [w for w in want if not (out / w).exists()]
    with np.load(out / "checkpoints" / f"iteration_{n}" / "state.npz") as ck:
        nodes = ck[".warp.nodes"].shape[0]
    state, it = rr.load_rig(out, cfg, scene, DEVICE)
    print(f"[resume] the stage-1 checkpoint's {nodes} nodes (init_stage1 makes {cfg.model.node_num}) read; the "
          f"resumed rig reloaded at iteration {it}, {int(state.gs.num_alive)} Gaussians, J = {state.skel.net.n_joints}")
    if missing or it != RESUME_ITERATIONS:
        raise RuntimeError(f"[resume] missing {missing}, or the rig reloaded at {it}")


def _flow_files(root, scene, gs, skel, names):
    """raft_neighbouring/<name>.flow_<partner>.npy of each train frame to its
    +-1 neighbours: the avatar's own motion between the two frames' times
    under the frame's camera, in pixels (render_flow's NDC displacement times
    half the size); raft_masks/ the render's solid pixels as the
    cycle-consistency channel, no occlusion channel. Returns the files'
    bytes."""
    import torch
    from PIL import Image

    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.render.api import render_flow

    (root / "raft_neighbouring").mkdir(parents=True)
    (root / "raft_masks").mkdir()
    fr = scene.train_frames
    n_bytes = 0
    with torch.no_grad():
        d = [SW.skeleton_forward(skel, gs.xyz, float(f.fid), gs.motion_mask) for f in fr]
        for i, f in enumerate(fr):
            for j in (i - 1, i + 1):
                if not 0 <= j < len(fr):
                    continue
                out = render_flow(f.cam, f.cam, gs, d[i]["d_xyz"], d[j]["d_xyz"], d[i]["d_rotation"],
                                  max_per_tile=16384)
                if int(out["overflow_tiles"]) or int(out["overflow_rect"]):
                    raise RuntimeError(f"[flow] the flow of frame {i} to {j} was truncated")
                size = torch.tensor([f.cam.width / 2.0, f.cam.height / 2.0], device=DEVICE)
                name = f"{names[i]}.flow_{names[j]}"
                np.save(root / "raft_neighbouring" / f"{name}.npy", (out["render"][..., :2] * size).cpu().numpy())
                m = np.zeros((f.cam.height, f.cam.width, 3), np.uint8)
                m[..., 0] = (out["alpha"] > 0.5).cpu().numpy() * 255
                Image.fromarray(m).save(root / "raft_masks" / f"{name}.png")
                n_bytes += sum(p.stat().st_size for p in (root / "raft_neighbouring" / f"{name}.npy",
                                                         root / "raft_masks" / f"{name}.png"))
    return n_bytes


def flow_phase(blend, scene, cap, gs, skel, loop_b_ms):
    """Phase 14: train_stage1 on the [loop] scene with RAFT-layout flow files
    of the avatar's own motion to each frame's neighbours (FLOW_WARM_UP: the
    flow term on phase B's steps 10-39), the counters zeroed just before and
    read just after: the steps that drew a partner, the flow term at the
    first and last flow step, ms per flow step against [loop]'s phase B,
    busy time and idle share over 5 flow steps, the flow render's overflow;
    then blend_cm and blend_cm_bwd held to their plain versions on a flow
    step's own flow render (signed colours), the ladder's kernels and the
    rotation fit on the same step; and a flow step under the sync audit.
    Returns (launch counts, held kernel results, rotation-fit results)."""
    import tempfile

    import torch

    from riggs_tpu_torch.data.flow import FlowStore
    from riggs_tpu_torch.ops import geometry as GEO
    from riggs_tpu_torch.train import stage1 as S1

    names = [f"f_{i:03d}" for i in range(len(scene.train_frames))]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        n_bytes = _flow_files(root, scene, gs, skel, names)
        flow_scene = dataclasses.replace(scene, train_image_names=names)
        print(f"[flow] scene: [loop]'s {len(names)} frames, {2 * len(names) - 2} flow files of the avatar's motion "
              f"to each frame's neighbours at {SIZE}x{SIZE} ({n_bytes} bytes with the masks); "
              f"{time.perf_counter() - t0:.1f} s")
        cfg = _stage1_config(CAPACITY)
        for k, v in LOOP_SCHEDULE.items():
            setattr(cfg.pipe if k == "ladder_check_every" else cfg.opt, k, v)
        cfg.opt.warm_up = FLOW_WARM_UP
        cfg.pipe.max_per_tile = cap
        events = []
        torch.cuda.synchronize()
        blend.reset_launches()
        GEO.reset_launches()
        t0 = time.perf_counter()
        with _LoopProbe(blend, held=FLOW_HELD) as probe:
            state, _ = S1.train_stage1(flow_scene, cfg, seed=0, events=events, step_callback=probe,
                                       source_path=tmp, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(blend.launches, **GEO.launches)
        terms = [(m["flow"], m["flow_overflow_tiles"], m["flow_overflow_rect"]) for m in probe.b_metrics]
        drew = [e for e in events if e["event"] == "flow"]
        flow_l1 = [float(t[0]) for t in terms]
        of = [(int(t[1]), int(t[2])) for t in terms]
        med, mean = probe.ms("B", since=FLOW_WARM_UP + 1)
        busy = probe.busy["B"]
        reset = cfg.opt.opacity_reset_interval
        print(f"[flow] train_stage1 {wall:.1f} s: {drew[0]['partners'] if drew else 0} of "
              f"{cfg.opt.iterations - FLOW_WARM_UP} flow steps drew a partner; flow_l1 {flow_l1[FLOW_WARM_UP]:.6f} at "
              f"it={FLOW_WARM_UP}, {flow_l1[reset]:.6f} at it={reset} (the opacity reset's step), "
              f"{flow_l1[-1]:.6f} at it={len(flow_l1) - 1}, steps {reset + 1}-{len(flow_l1) - 1} "
              f"{[round(v, 7) for v in flow_l1[reset + 1:]]}; 0 before it={FLOW_WARM_UP}; flow render overflow "
              f"(tiles, rect) summed {tuple(map(sum, zip(*of)))}")
        print(f"[flow] phase B with the flow term: {med:.2f} ms per step (host clock, median of steps "
              f"{FLOW_WARM_UP + 1}-39; mean {mean:.2f}), [loop]'s phase B {loop_b_ms:.2f} in this call; device busy "
              f"{busy:.2f} ms per step over steps {PROFILE_FROM}-{PROFILE_FROM + 4} (idle share {1 - busy / med:.3f}); "
              f"launch counters: {launches}")
        late = [e for e in events if "overflow" in e["event"]]
        refit_at = {e["it"] for e in events if e["event"] in ("ladder refit", "ladder fit")}
        bad = [e for e in late if e["event"] != "overflow" or e["phase"] == "A" or e["rect"] or e["it"] not in refit_at]
        if not drew or drew[0]["partners"] != cfg.opt.iterations - FLOW_WARM_UP:
            raise RuntimeError(f"[flow] {drew}: every flow step must draw a partner (each frame has two)")
        if not (max(flow_l1[:FLOW_WARM_UP]) == 0.0 and min(flow_l1[FLOW_WARM_UP:reset + 1]) > 0
                and all(map(np.isfinite, flow_l1))):
            raise RuntimeError(f"[flow] the flow term {flow_l1}: 0 before the warm-up's end, positive from it to "
                               "the opacity reset, finite")
        if any(a or b for a, b in of) or bad:
            raise RuntimeError(f"[flow] overflow: flow render {of}, events {bad}")
        for name in ("blend_cm", "blend_cm_bwd", "blend_permuted_gm", "blend_permuted_gm_bwd", "estimate_rotations"):
            if launches[name] <= 0:
                raise RuntimeError(f"[flow] the flow loop never launched {name}")
        held, held_rot = probe.held, probe.held_rot
        del probe
        (key, label), = FLOW_HELD.items()
        g = held[key]["blend_cm_fwd"][0][0]
        rgb = g[:, 6:9]
        print(f"[flow] {label}: {len(held[key]['blend_cm_fwd'])} blend_cm call(s), the flow render's: colour rows in "
              f"[{float(rgb.min()):.4f}, {float(rgb.max()):.4f}] (signed NDC flow, the motion mask)")
        if not (float(g[:, 6:8].min()) < 0 < float(g[:, 6:8].max())):
            raise RuntimeError("[flow] the held flow render's colours are not signed")
        kernels = check_loop_kernels(blend, held, labels=FLOW_HELD, want={"blend_cm": (label,),
                                                                          "blend_permuted_gm": (label,)}, tag="[flow]")
        rot = check_rotfit(held_rot[key], f"[flow] {label}")

        # a flow step under the sync audit: the partner's prepared flow, the step on the fitted ladder
        store = FlowStore(tmp, names, [float(f.fid) for f in scene.train_frames],
                          [(f.cam.height, f.cam.width) for f in scene.train_frames], device=DEVICE)
        ladder = [e for e in events if e["event"] == "ladder"][-1]["ladder"]
        step = S1.make_phase_b_auto(cfg)
        draws = S1.Stage1Draws(7, DEVICE)
        rng = np.random.default_rng(0)
        bg = torch.ones(3, device=DEVICE)
        fr = scene.train_frames[3]

        def step_fn(flow):
            def one():
                nonlocal state
                fl, fm, pfid = store.sample(3, rng)
                f = dataclasses.replace(fr, flow=fl, flow_mask=fm, flow_partner_fid=pfid)
                state, _ = step(state, f, bg, draws.phase_b(), it=20, use_chamfer=True, use_flow_loss=flow,
                                max_per_tile=cap, tile_ladder=ladder)
            return one

        # the flow term's cost: the same step with and without it, in turns
        for label, flow in (("step with the flow term", True), ("the same step without it", False)):
            one = step_fn(flow)
            for _ in range(4):  # warm-up: the step's key is captured as a CUDA graph by its fourth call
                one()
            profile_stage1(one, label, _host_ms(one, 5), tag="[flow]", it=20)
        one = step_fn(True)
        sync_audit("make_phase_b_auto with the flow loss (it=20, the fitted ladder, the flow drawn from FlowStore)",
                   one)
    return launches, kernels, rot


def _zju_camera(rng, angle):
    """A 1024 x 1024 ZJU-style camera about the avatar: K with the principal
    point tens of pixels off the centre, the world-to-camera of an arc view
    (as [loop]'s, at 2.6 m), a seeded SMPL global transform (Rh, Th) and the
    extrinsics that give that view once it is folded in, small seeded
    distortion."""
    from riggs_tpu_torch.data.zju import _rodrigues

    f = ZJU_SIZE / 2 / np.tan(0.4)
    K = np.array([[f, 0.0, ZJU_SIZE / 2 + rng.uniform(15, 35)], [0.0, f * 1.002, ZJU_SIZE / 2 - rng.uniform(15, 35)],
                  [0.0, 0.0, 1.0]])
    R = np.array([[np.cos(angle), 0.0, -np.sin(angle)], [0.0, -1.0, 0.0], [-np.sin(angle), 0.0, -np.cos(angle)]])
    center = np.array([2.6 * np.sin(angle), 0.15, 2.6 * np.cos(angle)])
    C = np.eye(4)
    C[:3, :3], C[:3, 3] = R, -R @ center
    Rh, Th = rng.normal(scale=0.2, size=3), rng.normal(scale=0.1, size=3)
    G = np.eye(4)
    G[:3, :3] = _rodrigues(Rh).T
    G[:3, 3] = -G[:3, :3] @ Th
    D = np.array([[rng.uniform(-0.03, -0.01), rng.uniform(0.0, 0.01), rng.uniform(-1e-3, 1e-3),
                   rng.uniform(-1e-3, 1e-3), 0.0]])
    return K, C, dict(intrinsics=K, extrinsics=C @ G, distortions=D), dict(Rh=Rh, Th=Th)


def write_zju_subject(root, gs, skel):
    """The one-subject data root <root>/377/ in the HumanNeRF layout that
    data/zju.py reads, from the avatar: ZJU_FRAMES train frames at
    ZJU_SIZE^2 (its render at time i / (ZJU_FRAMES - 1) from an arc camera of
    _zju_camera, black background), masks from the render's alpha, their
    thinned skeletons, SMPL_prior/ with ZJU_M of the avatar's Gaussians
    (a seeded subset) posed by its skeleton at each frame's time,
    points3d.ply the same points at rest with their colours, and two test
    views of one frame each. Returns the subject directory."""
    import pickle

    import torch
    from PIL import Image

    from riggs_tpu_torch.camera import make_camera
    from riggs_tpu_torch.data.dataset import thin_mask_skeleton
    from riggs_tpu_torch.io.ply import write_ply
    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.ops.sh import C0

    sub = root / "377"
    rng = np.random.default_rng(11)
    n = int(gs.num_alive)
    idx = torch.as_tensor(np.sort(rng.choice(n, ZJU_M, replace=False)), device=DEVICE)
    xyz = gs.xyz[idx]
    cols = np.clip(gs.features_dc[idx, 0].cpu().numpy() * C0 + 0.5, 0.0, 1.0) * 255.0
    p = xyz.cpu().numpy()
    write_ply(sub / "points3d.ply", dict(x=p[:, 0], y=p[:, 1], z=p[:, 2], red=cols[:, 0], green=cols[:, 1],
                                         blue=cols[:, 2]))
    (sub / "SMPL_prior").mkdir()
    black = torch.zeros(3, device=DEVICE)
    names = [f"frame_{i:06d}" for i in range(ZJU_FRAMES)]
    thin_s = 0.0

    def view(d, items, thinned):
        nonlocal thin_s
        for s in ("images", "masks") + (("train_thinned",) if thinned else ()):
            (d / s).mkdir(parents=True)
        cameras, infos = {}, {}
        for name, angle in items:
            t = int(name.split("_")[-1]) / (ZJU_FRAMES - 1)
            K, C, cameras[name], infos[name] = _zju_camera(rng, angle)
            cam = make_camera(C[:3, :3].T, C[:3, 3], ZJU_SIZE, ZJU_SIZE, K=K, device=DEVICE)
            out = frame(gs, skel, cam, black, t=t, max_per_tile=16384)
            _check_frame(out, ZJU_SIZE, f"[zju] {d.name} {name}")
            Image.fromarray((out["render"].clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()).save(
                d / "images" / f"{name}.png")
            mask = (out["alpha"] > 0.5).cpu().numpy()
            Image.fromarray(mask.astype(np.uint8) * 255).save(d / "masks" / f"{name}.png")
            if thinned:
                t1 = time.perf_counter()
                pix = thin_mask_skeleton(mask).astype(np.int64)
                thin_s += time.perf_counter() - t1
                tm = np.zeros(mask.shape, np.uint8)
                tm[pix[:, 0], pix[:, 1]] = 255
                Image.fromarray(tm).save(d / "train_thinned" / f"{name}_thinned.png")
            if not (sub / "SMPL_prior" / f"{name}.npy").exists():
                with torch.no_grad():
                    posed = xyz + SW.skeleton_forward(skel, gs.xyz, t, gs.motion_mask)["d_xyz"][idx]
                np.save(sub / "SMPL_prior" / f"{name}.npy", posed.cpu().numpy())
        for fname, obj in (("cameras.pkl", cameras), ("mesh_infos.pkl", infos)):
            with open(d / fname, "wb") as f:
                pickle.dump(obj, f)

    angles = np.radians(np.linspace(-LOOP_ARC_DEG, LOOP_ARC_DEG, ZJU_FRAMES))
    view(sub / "train", list(zip(names, angles)), True)
    for cid, i in ZJU_TEST_VIEWS:
        view(sub / "test" / f"view_{cid:02d}", [(names[i], (angles[i] + angles[i + 1]) / 2)], False)
    print(f"[zju] wrote {sub}: {ZJU_FRAMES} train frames and {len(ZJU_TEST_VIEWS)} test views at "
          f"{ZJU_SIZE}x{ZJU_SIZE}, {ZJU_M} SMPL-prior points a frame ({thin_s:.1f} s of thinning)")
    return sub


def _zju_config(cap):
    """scripts/run_zju.py's widths (the defaults: 65536 slots, SH 3, hyper_dim
    8; 512 nodes, the skinning MLP and template offsets on, the alpha mask
    as the scene mask), only the schedule cut (ZJU_SCHEDULE)."""
    from riggs_tpu_torch.train.config import Config

    cfg = Config()
    cfg.model.node_num = 512
    cfg.model.use_skinning_weight_mlp = cfg.model.use_template_offsets = True
    cfg.model.gt_alpha_mask_as_scene_mask = True
    for k, v in ZJU_SCHEDULE.items():
        setattr(cfg.pipe if k == "ladder_check_every" else cfg.opt, k, v)
    cfg.pipe.max_per_tile = cap
    return cfg


def zju_phase(blend, gs, skel):
    """Phase 15: the [zju] subject written from the avatar, load_scene on the
    card, then train_stage1 at scripts/run_zju.py's widths (capacity 65536,
    which riggs_tpu cannot run: ROADMAP C5), the counters zeroed just before
    and read just after: ms per reference-point and phase-B step, busy time
    and idle share of each, the reference loss at both ends, densification
    past ZJU_M alive; the four kernels and the rotation fit held on two
    phase-B steps (ZJU_HELD); a reference-point step under the sync audit;
    then scripts/torch_run_zju.py as a process of its own on the subject.
    Returns (launch counts, held kernel results, rotation-fit results)."""
    import tempfile

    import torch

    from riggs_tpu_torch.data.scene import load_scene
    from riggs_tpu_torch.ops import geometry as GEO
    from riggs_tpu_torch.render.api import render
    from riggs_tpu_torch.train import stage1 as S1

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sub = write_zju_subject(Path(tmp), gs, skel)
        print(f"[zju] subject written in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        scene = load_scene(sub, device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        f0 = scene.train_frames[0]
        intr = f0.cam.intrinsics.tolist()
        print(f"[zju] load_scene {load_s:.2f} s: {len(scene.train_frames)} train and {len(scene.test_frames)} test "
              f"frames, {len(scene.init_points)} init points, reference points {tuple(f0.reference_points.shape)}, "
              f"thinned {int(f0.thinned_mask.sum())} pixels, principal point ({intr[2]:.1f}, {intr[3]:.1f}) in "
              f"{f0.cam.width}x{f0.cam.height}, cameras_extent {scene.cameras_extent:.4f}")
        got = (len(scene.train_frames), len(scene.test_frames), len(scene.init_points))
        if got != (ZJU_FRAMES, len(ZJU_TEST_VIEWS), ZJU_M):
            raise RuntimeError("[zju] the reader's frame or point counts differ from the subject's")
        # the probe steps' plain window: four times the initial cloud's largest
        # tile count (densification grows it before the ladder's fit), at least 1024
        cfg = _zju_config(1024)
        state0 = S1.init_stage1(scene, cfg, generator=torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
        with torch.no_grad():
            counts = [int(render(f.cam, state0.gs, torch.zeros(3, device=DEVICE), max_per_tile=16384)["max_count"])
                      for f in scene.train_frames[::4]]
        cap = cfg.pipe.max_per_tile = int(-(-max(1024, 4 * max(counts)) // 128) * 128)
        events = []
        torch.cuda.synchronize()
        blend.reset_launches()
        GEO.reset_launches()
        t0 = time.perf_counter()
        with _LoopProbe(blend, held=ZJU_HELD) as probe:
            state, hist = S1.train_stage1(scene, cfg, seed=0, log_every=ZJU_SCHEDULE["iterations"] - 1, state=state0,
                                          events=events, step_callback=probe, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(blend.launches, **GEO.launches)
        for e in events:
            print(f"[zju] event {e}")
        for p, it, m in hist:
            print(f"[zju] {p} it={it}: " + " ".join(f"{k} {v:.5f}" for k, v in m.items() if k in
                                                    ("loss", "ref_loss", "chamfer", "psnr")))
        for p, what in (("A", "reference-point"), ("B", "phase-B")):
            med, mean = probe.ms(p)
            busy = probe.busy[p]
            print(f"[zju] {what} step: {med:.2f} ms (host clock, median; mean {mean:.2f} with the events), device busy "
                  f"{busy:.2f} ms per step over steps {PROFILE_FROM}-{PROFILE_FROM + 4} (idle share "
                  f"{1 - busy / med:.3f})")
        dens = [e for e in events if e["event"] == "gs densify"]
        print(f"[zju] train_stage1 {wall:.1f} s (window {cap}, from max tile counts {counts}); launch counters: "
              f"{launches}; alive "
              f"{[(e['it'], e['before'], e['after']) for e in dens]}, {int(state.gs.num_alive)} of {state.gs.capacity}")
        refs = [m["ref_loss"] for p, _, m in hist if p == "A"]
        if not (len(refs) == 2 and refs[-1] < refs[0]):
            raise RuntimeError(f"[zju] the reference loss did not fall: {refs}")
        if not dens or dens[-1]["after"] <= ZJU_M or [e for e in events if e["phase"] == "A"]:
            raise RuntimeError(f"[zju] densification never grew past {ZJU_M} alive, or phase A fired an event")
        # the rect tiers' overflow is the cell's own (the sparse SMPL cloud's
        # first splats span more cells than the default tiers hold at 1024^2):
        # reported, where the reference's steps truncate silently; a window
        # overflow must be answered by a ladder refit one step late
        rect = [(e["it"], e["rect"]) for e in events if e["event"] == "overflow" and e["rect"]]
        if rect:
            print(f"[zju] overflow_rect on {len(rect)} phase-B steps (Gaussians past the rect tiers): max "
                  f"{max(r for _, r in rect)}, at it={rect[0][0]} {rect[0][1]}, the last at it={rect[-1][0]} "
                  f"{rect[-1][1]}")
        refit_at = {e["it"] for e in events if e["event"] in ("ladder refit", "ladder fit")}
        bad = [e for e in events if "overflow" in e["event"] and e["tiles"] and e["it"] not in refit_at]
        if bad:
            raise RuntimeError(f"[zju] steps overflowed their windows without the ladder reacting: {bad}")
        for name in ("blend_cm", "blend_cm_bwd", "blend_permuted_gm", "blend_permuted_gm_bwd", "estimate_rotations"):
            if launches[name] <= 0:
                raise RuntimeError(f"[zju] the loop never launched {name}")
        held, held_rot = probe.held, probe.held_rot
        del probe
        labels = list(ZJU_HELD.values())
        kernels = check_loop_kernels(blend, held, labels=ZJU_HELD, tag="[zju]",
                                     want={"blend_cm": (labels[0],), "blend_permuted_gm": (labels[1],)})
        rot = {label: check_rotfit(held_rot[key], f"[zju] {label}") for key, label in ZJU_HELD.items()}

        step_ref = S1.make_phase_ref_auto(cfg)
        fr = scene.train_frames[5]

        def one():
            nonlocal state
            state, _ = step_ref(state, fr, it=1, use_chamfer=True)

        one()
        sync_audit("make_phase_ref_auto (ZJU, it=1)", one)
        del state, scene
        zju_cli(Path(tmp))
    return launches, kernels, rot


def zju_cli(root):
    """scripts/torch_run_zju.py --data_root <root> --subjects 377 as a
    process of its own (ZJU_CLI_SCHEDULE as --extra): exit 0, every file
    that scripts/run_zju.py's chain writes, J, the test metrics."""
    root_dir = Path(__file__).resolve().parent
    out = root / "out"
    cmd = [sys.executable, str(root_dir / "scripts" / "torch_run_zju.py"), "--data_root", str(root), "--out_root",
           str(out), "--subjects", "377", "--extra", "--test_every", str(CLI_TEST_EVERY)]
    for k, v in ZJU_CLI_SCHEDULE.items():
        cmd += [f"--{k}", str(v)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root_dir, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    tail = [line for line in res.stdout.splitlines() if line.strip()][-3:]
    print(f"[zju] torch_run_zju.py exit {res.returncode} in {wall:.1f} s: {tail}")
    if res.returncode != 0:
        raise RuntimeError(f"[zju] torch_run_zju.py failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    n, sub = ZJU_CLI_SCHEDULE["iterations"], out / "377"
    want = ["cfg.json", "skeleton_tree.npz", "skeleton.obj", "numerical_res.txt",
            f"checkpoints/iteration_{n}/state.npz", f"point_cloud/iteration_{n}/point_cloud.ply",
            f"rig/checkpoints/iteration_{CLI_TEST_EVERY}/state.npz", f"rig/checkpoints/iteration_{n}/state.npz",
            f"rig/point_cloud/iteration_{n}/point_cloud.ply", "synthesis/render/numerical_res.txt"]
    missing = [w for w in want if not (sub / w).exists()]
    if missing or not list((sub / "synthesis" / "render").glob("video.*")):
        raise RuntimeError(f"[zju] torch_run_zju.py did not write {missing} or the video")
    texts = [(sub / w).read_text() for w in ("numerical_res.txt", "synthesis/render/numerical_res.txt")]
    vals = [float(x) for text in texts for line in text.splitlines()[1:] for x in line.split("\t")[1:]]
    with np.load(sub / "skeleton_tree.npz") as tree:
        J = len(tree["parents"])
    means = texts[1].splitlines()[-1]
    print(f"[zju] run_zju chain: every file written; J = {J}; test metrics (mean row) {means!r}; the render twin's "
          f"table equal to the pipeline's: {texts[0] == texts[1]}")
    if not vals or not all(np.isfinite(vals)) or texts[0] != texts[1] or J < 2:
        raise RuntimeError(f"[zju] the tables {texts} or J = {J}")


# [refpoint]: scripts/torch_run_refpoint.py at its full width (800², 131072
# slots, 512 nodes, max_per_tile 768, the biped scene), only the schedule
# cut; then again with --resume. The report's keys are the reference's
# (scripts/run_refpoint.py:140, 183-189, 204-209, 230, 258)
REFPOINT_ARGS = ("--frames", "8", "--s1a", "40", "--s1b", "40", "--s2", "60", "--test_every", "30")
REFPOINT_KEYS = {"size", "capacity", "frames", "s1_prefix_iters", "s1_wall_s", "s1_ms_per_iter",
                 "mem_live_gb_after_s1", "s1_alive_gaussians", "s2_prefix_iters", "s2_wall_s", "s2_ms_per_iter",
                 "mem_live_gb_after_s2", "joints", "test", "extrapolated_full_budget_hours"}
# [binners]: the serving frame's time, the quarter budget of render_auto's
# compact escalation
BINNERS_T = 0.3
# [static] and [mlpdeform]: 40 steps on the [loop] scene; one densification
# (20) and, for static, one opacity reset (30); the MLP frozen for 10 steps
SIDE_SCHEDULE = dict(iterations=40, densify_from_iter=5, densification_interval=20, opacity_reset_interval=30,
                     warm_up=10)
SIDE_HELD = {("S", 25): "step it=25"}
SIDE_PROFILE_FROM = {"S": 12}
# [hash]: the card against the CPU on the same weights and points, per
# column of each output and gradient leaf: max |d| <= tol * max |CPU| (f32
# products in another order; the tables' gradient is an index-add whose
# atomic order on the card is not fixed)
HASH_TOL = {"value": 1e-4, "grad": 1e-3}
# arap_loss_with_rot, card vs CPU: the loss relative; its gradient per
# leaf, scaled by the leaf's largest |CPU| value or a hundredth of the
# tree's largest, whichever is more (the d_xyz head's bias is 0 exactly:
# ARAP does not see a translation of all nodes, so the leaf holds only
# cancellation noise), within BWD_TOL
ARAP_ROT_TOL = {"loss": 1e-3, "grad": BWD_TOL}


def refpoint_phase():
    """Phase 17: scripts/torch_run_refpoint.py as a process of its own at
    its full width with REFPOINT_ARGS, then again with --resume (the
    stage-1 .npz and the stage-2 checkpoint read back): exit 0, every key
    of the reference's report on the last line, finite ms per step, J >= 2.
    Returns the first run's report and its kernel launches."""
    import tempfile

    root = Path(__file__).resolve().parent
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "rp"
        for extra in ((), ("--resume",)):
            cmd = [sys.executable, str(root / "scripts" / "torch_run_refpoint.py"), *REFPOINT_ARGS, "--out", str(out),
                   *extra]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=900)
            wall = time.perf_counter() - t0
            lines = [line for line in res.stdout.splitlines() if line.strip()]
            for line in lines[:-1]:
                print(f"[refpoint] {line}")
            print(f"[refpoint] torch_run_refpoint.py {' '.join(extra)} exit {res.returncode} in {wall:.1f} s")
            if res.returncode != 0:
                raise RuntimeError(f"[refpoint] failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
            report = json.loads(lines[-1])
            print(f"[refpoint] report {json.dumps(report)}")
            if set(report) != REFPOINT_KEYS:
                raise RuntimeError(f"[refpoint] report keys {sorted(report)}, not the reference's")
            for k in ("s1_ms_per_iter", "s2_ms_per_iter", "extrapolated_full_budget_hours"):
                if not (np.isfinite(report[k]) and report[k] > 0):
                    raise RuntimeError(f"[refpoint] {k} = {report[k]}")
            if report["joints"] < 2 or not all(np.isfinite(v) for v in report["test"].values()):
                raise RuntimeError(f"[refpoint] J = {report['joints']}, test {report['test']}")
            launches = json.loads(next(l for l in lines if l.startswith("kernel launches: "))[17:])
            runs.append((report, launches, lines))
    _, _, resumed = runs[1]
    if not any(l.startswith("stage-1 state resumed") for l in resumed) or not any(
            l.startswith("stage-2 resume") or l.startswith("stage-2 no resume") for l in resumed):
        raise RuntimeError("[refpoint] --resume did not read the stage-1 state and the stage-2 checkpoint")
    if runs[1][0]["s1_alive_gaussians"] != runs[0][0]["s1_alive_gaussians"]:
        raise RuntimeError("[refpoint] the resumed stage-1 state is not the saved one")
    for name in ("blend_cm", "blend_cm_bwd", "blend_permuted_gm", "blend_permuted_gm_bwd", "estimate_rotations"):
        if runs[0][1][name] <= 0:
            raise RuntimeError(f"[refpoint] the twin never launched {name}")
    return runs[0][0], runs[0][1]


class _GatherHold:
    """Capture each structural window gather of a render (the packed rows,
    the binner's by-products) and the gradient its output receives."""

    def __init__(self):
        from riggs_tpu_torch.render import tiles

        self.tiles, self.calls = tiles, []

    def __enter__(self):
        self.orig = (self.tiles.gather_instances, self.tiles.gather_grid)
        for i, name in enumerate(("gather_instances", "gather_grid")):
            def rec(packed, a, b, _fn=self.orig[i], _name=name):
                out = _fn(packed, a, b)  # (idx, CompactInfo) or (GridInfo, K)
                entry = {"name": _name, "packed": packed.detach(), "args": (a, b)}
                out.register_hook(lambda g, e=entry: e.__setitem__("dg", g.detach()))
                self.calls.append(entry)
                return out
            setattr(self.tiles, name, rec)
        return self

    def __exit__(self, *exc):
        self.tiles.gather_instances, self.tiles.gather_grid = self.orig


def _hold_gather(entry):
    """A structural gather backward against autograd's own index backward of
    packed[idx] on the dg the render gave it: per column max |d| <=
    BWD_TOL * max |index backward|."""
    import torch

    from riggs_tpu_torch.render import tiles

    a, b = entry["args"]
    p = entry["packed"].clone().requires_grad_(True)
    if entry["name"] == "gather_instances":
        out, idx = tiles.gather_instances(p, a, b), a
    else:
        out, idx = tiles.gather_grid(p, a, b), a.order[a.drank_win]
    (structural,) = torch.autograd.grad(out, p, entry["dg"], retain_graph=True)
    p2 = entry["packed"].clone().requires_grad_(True)
    (plain,) = torch.autograd.grad(p2[idx.to(torch.int64)], p2, entry["dg"])
    e, sc = _column_err(structural, plain, 1)
    rel = float(torch.where(sc > 0, e / sc.clamp(min=1e-30), e).max())
    torch.cuda.synchronize()
    ms_s = _event_ms(lambda: torch.autograd.grad(out, p, entry["dg"], retain_graph=True), 5)
    return rel, float(e.max()), ms_s


def binners_phase(blend, gs, skel, cam, bg, cap, target):
    """Phase 18: the serving avatar at full width through
    render(binning="compact") and render(binning="sort2"), forward and the
    gradient of a photometric loss, with the counters zeroed just before and
    read just after: each frame against the sort binner's (PATH_TOL, where
    no binner overflows), each gradient per column against the sort
    binner's (BWD_TOL), blend_cm and blend_cm_bwd held to their plain
    versions on each binner's windows, each structural gather backward held
    to autograd's index backward on the render's own dg; then
    render_auto(binning="compact") from a quarter of the frame's instances,
    its escalation and its frame against the default budget's; frame ms and
    busy time of each binner against sort's. Returns the launches and the
    held results."""
    import torch

    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.render import api as API

    with torch.no_grad():
        d = SW.skeleton_forward(skel, gs.xyz, BINNERS_T, gs.motion_mask)

    def run(binning, grad=True, window=None):
        params = {k: v.detach().requires_grad_(grad) for k, v in gs.params_dict().items()}
        out = API.render(cam, gs.replace_params(params), bg, d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                         d_scaling=torch.zeros_like(d["d_scaling"]), active_sh_degree=gs.max_sh_degree,
                         max_per_tile=window or cap, binning=binning)
        if not grad:
            return out, None
        loss = torch.mean((out["render"] - target) ** 2)
        names = [k for k, v in params.items() if k != "feature"]
        return out, dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))

    # the binners' window: compact and sort2 have no cell cull, so their
    # tiles hold more instances than the sort binner's; one window for all three
    probe, _ = run("compact", grad=False, window=16384)
    cap = max(cap, int(-(-int(probe["max_count"]) // 128) * 128))
    print(f"[binners] window {cap} (the compact binner's largest tile count {int(probe['max_count'])})")
    sort_out, sort_g = run("sort")
    torch.cuda.synchronize()
    blend.reset_launches()
    captured = {}
    for binning in ("compact", "sort2"):
        with _Capture(blend, ("blend_cm_fwd", "blend_cm_bwd")) as cap_calls, _GatherHold() as gh:
            out, g = run(binning)
        captured[binning] = (out, g, cap_calls.calls, gh.calls)
    torch.cuda.synchronize()
    launches = dict(blend.launches)
    print(f"[binners] launch counters over the compact and sort2 renders and gradients: {launches}")
    for name in ("blend_cm", "blend_cm_bwd"):
        if launches[name] <= 0:
            raise RuntimeError(f"[binners] never launched {name}")
    res = {}
    for binning, (out, g, calls, gathers) in captured.items():
        over = {k: int(out[k]) for k in ("overflow_tiles", "overflow_rect")}
        if not any(over.values()):
            _check_frame(out, SIZE, f"[binners] {binning}")
            _compare(out, sort_out, f"{binning} vs sort frame", tag="[binners]")
        else:
            print(f"[binners] {binning} overflowed {over}: the frame is not compared")
        worst = 0.0
        for k, a in g.items():
            e, sc = _column_err(a, sort_g[k], -1)
            rel = float(torch.where(sc > 0, e / sc.clamp(min=1e-30), e).max())
            worst = max(worst, rel)
            if not rel <= BWD_TOL:
                raise RuntimeError(f"[binners] {binning} gradient {k} vs sort: column error {rel:.3e} > {BWD_TOL}")
        print(f"[binners] {binning} vs sort gradient: max column error / max |sort| {worst:.3e} over "
              f"{sorted(g)}; overflow {over}")
        fwd = check_kernels(blend, {"blend_cm": calls["blend_cm_fwd"]}, tag=f"[binners] {binning}",
                            per="frame")["blend_cm"]
        bwd = check_bwd_kernels(blend, {"blend_cm_bwd": calls["blend_cm_bwd"]},
                                tag=f"[binners] {binning}")["blend_cm_bwd"]
        if len(gathers) != 1 or "dg" not in gathers[0]:
            raise RuntimeError(f"[binners] {binning}: {len(gathers)} structural gathers captured")
        rel, err, ms_bwd = _hold_gather(gathers[0])
        print(f"[binners] {binning} {gathers[0]['name']} backward vs the index backward on the render's dg: "
              f"column error {rel:.3e} (max |d| {err:.3e}); {ms_bwd:.3f} ms")
        if not rel <= BWD_TOL:
            raise RuntimeError(f"[binners] {binning} structural backward: column error {rel:.3e} > {BWD_TOL}")
        res[binning] = {"fwd": fwd, "bwd": bwd, "gather_rel": rel}
    del captured

    # render_auto's compact escalation from a quarter of the real instances
    default, _ = run("compact", grad=False)
    instances = int(default["tile_counts"].sum())
    budgets = []
    real_render = API.render

    def rec(*a, **k):
        budgets.append(k.get("max_instances"))
        return real_render(*a, **k)

    API.render = rec
    try:
        with torch.no_grad():
            auto = API.render_auto(cam, gs, bg, max_per_tile=cap, binning="compact", max_instances=instances // 4,
                                   d_xyz=d["d_xyz"], d_rotation=d["d_rotation"],
                                   d_scaling=torch.zeros_like(d["d_scaling"]), active_sh_degree=gs.max_sh_degree)
    finally:
        API.render = real_render
    same = torch.equal(auto["render"], default["render"])
    print(f"[binners] render_auto(binning='compact') from {instances // 4} of {instances} instances: budgets "
          f"{budgets}; settled with overflow {int(auto['overflow'])}; frame bitwise equal to the default budget's: "
          f"{same}")
    if len(budgets) < 3 or int(auto["overflow"]):
        raise RuntimeError(f"[binners] the compact escalation did not settle: budgets {budgets}")
    _compare(auto, default, "render_auto compact vs the default budget", tag="[binners]")

    # frame time and device busy: each binner against sort
    for binning in ("sort", "compact", "sort2"):
        fn = lambda b=binning: run(b, grad=False)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 10 * 1e3
        busy = _profile_busy(fn, 5)
        res.setdefault(binning, {}).update(frame_ms=ms, busy_ms=busy)
        print(f"[binners] {binning}: {ms:.2f} ms per frame (render alone, host clock), device busy {busy:.2f} ms "
              f"(idle share {1 - busy / ms:.3f})")
    return launches, res


def _side_config(cap):
    cfg = _stage1_config(CAPACITY)
    for k, v in SIDE_SCHEDULE.items():
        setattr(cfg.opt, k, v)
    cfg.pipe.max_per_tile = cap
    return cfg


def _side_probe(blend):
    probe = _LoopProbe(blend, held=SIDE_HELD, profile_from=SIDE_PROFILE_FROM)
    return probe, (lambda st, it: probe(st, it, "S"))


def _side_report(tag, probe, launches, wall):
    med, mean = probe.ms("S")
    busy = probe.busy["S"]
    print(f"{tag} {len(probe.stamps['S'])} steps in {wall:.1f} s, {med:.2f} ms per step (host clock, median; mean "
          f"{mean:.2f} with the events), device busy {busy:.2f} ms over steps {SIDE_PROFILE_FROM['S']}-"
          f"{SIDE_PROFILE_FROM['S'] + 4} (idle share {1 - busy / med:.3f}); launch counters {launches}")
    for name in ("blend_cm", "blend_cm_bwd"):
        if launches[name] <= 0:
            raise RuntimeError(f"{tag} never launched {name}")
    return {"ms": med, "busy_ms": busy}


def static_phase(blend, scene, cap):
    """Phase 19: train_static on the [loop] scene at full width (131072
    slots, SH 3, the scene's 100000 points; SIDE_SCHEDULE: one
    densification, one opacity reset), the counters zeroed just before and
    read just after: loss, alive counts, ms per step and busy time; blend_cm
    and its backward held on SIDE_HELD's step; a train_step with no host
    read."""
    import torch

    from riggs_tpu_torch.train import static as TST

    cfg = _side_config(cap)
    data = [(f.cam, f.image) for f in scene.train_frames]
    white = torch.ones(3, device=DEVICE)
    torch.cuda.synchronize()
    blend.reset_launches()
    probe, cb = _side_probe(blend)
    t0 = time.perf_counter()
    with probe:
        state, hist = TST.train_static(data, cfg, SIDE_SCHEDULE["iterations"], scene.init_points, scene.init_colors,
                                       bg=white, log_every=SIDE_SCHEDULE["iterations"] - 1, step_callback=cb,
                                       device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(blend.launches)
    for it, m in hist:
        print(f"[static] it={it}: loss {m['loss']:.5f} psnr {m['psnr']:.2f} alive {int(m['num_alive'])}")
    if not all(np.isfinite(m["loss"]) for _, m in hist) or len(hist) != 2:
        raise RuntimeError(f"[static] history {hist}")
    times = _side_report("[static]", probe, launches, wall)
    held = check_loop_kernels(blend, probe.held, labels=SIDE_HELD, want={"blend_cm": ("step it=25",)}, tag="[static]")
    del probe
    lrs = TST.f32_lrs(TST.make_lr_schedules(cfg), 39)
    f = scene.train_frames[0]
    sync_audit("static train_step", lambda: TST.train_step(state, f.cam, f.image, white, lrs, active_sh=0,
                                                           max_per_tile=cap))
    return launches, held, times


def mlpdeform_phase(blend, scene, cap):
    """Phase 20: train_mlp_deform on the [loop] scene at full width (the
    default 8x256 blender DeformNetwork at every one of 131072 slots;
    SIDE_SCHEDULE: warm-up 10, one densification), the counters zeroed just
    before and read just after: the MLP's weights and Adam state bitwise
    unchanged through the warm-up and changed after it; loss, ms per step
    and busy time; blend_cm and its backward held on SIDE_HELD's step; an
    mlp_deform_step with no host read."""
    import torch

    from riggs_tpu_torch.train import mlp_deform as TMD
    from riggs_tpu_torch.train.optim import tree_leaves

    cfg = _side_config(cap)
    warm = SIDE_SCHEDULE["warm_up"]

    def leaves(st):
        return [t.detach().clone() for t in tree_leaves((st.deform.params_dict(), st.opt_deform.mu,
                                                         st.opt_deform.nu, st.opt_deform.count))]

    init = TMD.init_mlp_deform_state(scene, cfg, generator=torch.Generator(device=DEVICE).manual_seed(0),
                                     device=DEVICE)
    before, frozen = leaves(init), {}
    torch.cuda.synchronize()
    blend.reset_launches()
    probe, cb = _side_probe(blend)

    def watch(st, it):
        if it == warm - 1:
            frozen["warm"] = all(torch.equal(a, b) for a, b in zip(before, leaves(st)))
        cb(st, it)

    t0 = time.perf_counter()
    with probe:
        state, hist = TMD.train_mlp_deform(scene, cfg, log_every=SIDE_SCHEDULE["iterations"] - 1, state=init,
                                           step_callback=watch, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(blend.launches)
    changed = sum(not torch.equal(a, b) for a, b in zip(before, leaves(state)))
    for it, m in hist:
        print(f"[mlpdeform] it={it}: loss {m['loss']:.5f} psnr {m['psnr']:.2f} alive {int(m['n_gs'])}")
    print(f"[mlpdeform] the MLP's {len(before)} weight and Adam leaves bitwise unchanged through the warm-up: "
          f"{frozen.get('warm')}; {changed} changed after it (Adam count {int(state.opt_deform.count)})")
    if not frozen.get("warm") or changed < len(before) - 1 or int(state.opt_deform.count) != (
            SIDE_SCHEDULE["iterations"] - warm):
        raise RuntimeError("[mlpdeform] the warm-up freeze or the updates after it are wrong")
    if not all(np.isfinite(m["loss"]) for _, m in hist):
        raise RuntimeError(f"[mlpdeform] history {hist}")
    times = _side_report("[mlpdeform]", probe, launches, wall)
    held = check_loop_kernels(blend, probe.held, labels=SIDE_HELD, want={"blend_cm": ("step it=25",)},
                              tag="[mlpdeform]")
    del probe
    gauss_lrs, deform_lr = TMD.stage1_lr_fns(cfg)
    f = scene.train_frames[1]
    white = torch.ones(3, device=DEVICE)
    sync_audit("mlp_deform_step", lambda: TMD.mlp_deform_step(state, f, white, gauss_lrs(39), deform_lr(39),
                                                              max_per_tile=cap))
    return launches, held, times


def _leafwise(a, b, tol, what):
    """Per column of each leaf (the last axis): max |a - b| <= tol * max |b|."""
    import torch

    worst = 0.0
    for k in a:
        x, y = a[k].detach().cpu(), b[k].detach()
        e, sc = _column_err(x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1]), -1)
        rel = float(torch.where(sc > 0, e / sc.clamp(min=1e-30), e).max())
        worst = max(worst, rel)
        if not rel <= tol:
            raise RuntimeError(f"{what} {k}: card vs CPU column error {rel:.3e} > {tol}")
    return worst


def hash_phase(gs, warp):
    """Phase 21: apply_hash_deform at the default grid (16 levels x 2^17 x
    2, width 64, depth 2) over the avatar's 131072 slots, forward and the
    gradient of a seeded projection of its heads, on the card against the
    CPU on the same weights (HASH_TOL); then arap_loss_with_rot on the
    [loop]'s trained 512-node warp, with and without the rotation term, on
    the card against the CPU on the same draws (ARAP_ROT_TOL), the
    rotation-fit counter zeroed just before and read just after, and the
    kernel's fits of those losses held to their plain version
    (check_rotfit). Returns the launches and that check's result."""
    import torch

    from riggs_tpu_torch.models import hash_encoding as H
    from riggs_tpu_torch.models import node_warp as NW
    from riggs_tpu_torch.ops import geometry as GEO
    from riggs_tpu_torch.train.optim import tree_leaves

    net_cpu = H.HashDeformNetwork(generator=torch.Generator().manual_seed(7), device="cpu")
    net_dev = copy.deepcopy(net_cpu).to(DEVICE)
    x_dev = gs.xyz.detach()
    x_cpu = x_dev.cpu()
    rng = np.random.default_rng(7)
    heads = ("d_xyz", "d_rotation", "d_scaling")
    cot = {k: rng.normal(size=(x_cpu.shape[0], w)).astype(np.float32) for k, w in zip(heads, (3, 4, 3))}

    def run(net, x):
        out = H.apply_hash_deform(net, x, 0.3)
        loss = sum(torch.sum(out[k] * torch.as_tensor(cot[k], device=x.device)) for k in heads)
        leaves = tree_leaves(net.params_dict())
        return {k: out[k] for k in heads}, dict(enumerate(torch.autograd.grad(loss, leaves)))

    vd, gd = run(net_dev, x_dev)
    vc, gc = run(net_cpu, x_cpu)
    v_err = _leafwise(vd, vc, HASH_TOL["value"], "[hash] output")
    g_err = _leafwise(gd, gc, HASH_TOL["grad"], "[hash] gradient")
    torch.cuda.synchronize()
    ms = _event_ms(lambda: run(net_dev, x_dev), 5)
    print(f"[hash] apply_hash_deform over {x_cpu.shape[0]} points ({net_cpu.grid.n_levels} levels x "
          f"{net_cpu.grid.table_size} x {net_cpu.grid.features}): card vs CPU column error outputs {v_err:.2e}, "
          f"gradients {g_err:.2e} (tables' index-add included); forward and backward {ms:.3f} ms on the card")

    gen = torch.Generator().manual_seed(11)
    t_samp, fid = NW.arap_rot_draws(gen, device="cpu")
    warp_cpu = copy.deepcopy(warp).to("cpu")
    GEO.reset_launches()
    results = []
    with _RotCapture() as rot:
        for rot_term in (False, True):
            wd, wc = copy.deepcopy(warp), copy.deepcopy(warp_cpu)
            wd.d_rot_as_res = wc.d_rot_as_res = not rot_term
            ld = NW.arap_loss_with_rot(wd, t_samp.to(DEVICE), fid.to(DEVICE))
            lc = NW.arap_loss_with_rot(wc, t_samp, fid)
            pd, pc = tree_leaves(wd.mlp.params_dict()), tree_leaves(wc.mlp.params_dict())
            gd = torch.autograd.grad(ld, pd, allow_unused=True)
            gc = torch.autograd.grad(lc, pc, allow_unused=True)
            results.append((rot_term, ld.detach(), lc.detach(), gd, gc))
    torch.cuda.synchronize()
    launches = dict(GEO.launches)
    print(f"[hash] rotation-fit launches over the two card losses: {launches}")
    if launches["estimate_rotations"] <= 0:
        raise RuntimeError("[hash] arap_loss_with_rot never launched the rotation fit")
    for rot_term, ld, lc, gd, gc in results:
        pairs = [(a, b.to(a.device)) for a, b in zip(gd, gc) if a is not None and b is not None]
        tree_max = max(float(b.abs().max()) for _, b in pairs)
        g_err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-2 * tree_max, 1e-30) for a, b in pairs)
        rel = abs(float(ld) - float(lc)) / max(abs(float(lc)), 1e-30)
        print(f"[hash] arap_loss_with_rot on {warp.node_num} nodes ({'with' if rot_term else 'without'} the rotation "
              f"term): card {float(ld):.6e}, CPU {float(lc):.6e}, relative {rel:.2e}; gradient leaf error {g_err:.2e} "
              f"over {len(pairs)} leaves")
        if not (rel <= ARAP_ROT_TOL["loss"] and g_err <= ARAP_ROT_TOL["grad"]):
            raise RuntimeError(f"[hash] arap_loss_with_rot card vs CPU: loss {rel:.3e}, gradient {g_err:.3e}; "
                               f"limits {ARAP_ROT_TOL}")
    fits = [f for f in rot.fits if f[0].device.type == "cuda"]
    return launches, check_rotfit(fits, "[hash] arap_loss_with_rot")


TILESHARD_STEPS = 5  # dp steps of each mesh shape
TILESHARD_LOOP = 20  # train_stage2_dp iterations at 1 x 2
TILESHARD_LADDER_LOOP = 28  # and at 2 x 1 with the ladder: 14 steps, the fit after 12 (LadderPolicy's probe)
TILESHARD_SCHEDULE = dict(iterations_stage2=TILESHARD_LOOP, skeleton_warm_up=5, optimize_template_offsets_iters=10,
                          gs_densification_iterations=5, densify_from_iter=12, densify_until_iter=18,
                          densification_interval=5)
TILESHARD_LRS = {"xyz": 1.6e-4, "f_dc": 2.5e-3, "f_rest": 1.25e-4, "opacity": 0.05, "scaling": 1e-3,
                 "rotation": 1e-3, "feature": 2.5e-3}
TILESHARD_TIMEOUT = 600


def _state_leaves(state):
    """A Stage2State's tensors by path."""
    from riggs_tpu_torch.train.optim import tree_leaves

    out = {}
    for name, tree in (("gs", state.gs.params_dict()), ("skel", state.skel.params_dict()),
                       ("opt_gs", (state.opt_gs.mu, state.opt_gs.nu, state.opt_gs.count)),
                       ("opt_skel", (state.opt_skel.mu, state.opt_skel.nu, state.opt_skel.count)),
                       ("stats", dataclasses.astuple(state.stats_gs)), ("rest", (state.proj_loss, state.it))):
        for i, v in enumerate(tree_leaves(tree)):
            out[f"{name}.{i}"] = v.detach()
    return out


def _state_hash(state):
    return _leaves_hash(_state_leaves(state))


def _leaves_hash(leaves):
    """A hash of tensors by path (their bytes, in path order)."""
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(leaves.items()):
        h.update(k.encode())
        h.update(v.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _state_diff(a, b):
    """Per leaf max |a - b| / max |b| (the worst; an integer leaf that
    differs counts as inf), and whether every leaf is bitwise equal."""
    return _leaves_diff(_state_leaves(a), _state_leaves(b))


def _leaves_diff(la, lb):
    """_state_diff of two states' leaves (_state_leaves)."""
    import torch

    worst, same = 0.0, True
    for k, y in lb.items():
        x = la[k]
        if not y.is_floating_point():
            eq = torch.equal(x, y)
            same &= eq
            worst = worst if eq else float("inf")
            continue
        same &= _same_bits(x, y)
        if y.numel():
            s, e = float(y.abs().max()), float((x - y).abs().max())
            worst = max(worst, e / s if s > 0 else e)
    return worst, same


def _tileshard_inputs(device):
    """The avatar and the [train] frame, its deformations, configuration and
    flags at it = 15001 (a fresh state per use)."""
    gs, skel, cam, bg = build_avatar(0, N_ALIVE, CAPACITY, SIZE, device)
    fr, pre_d_xyz, pre_d_joints, cfg = build_training(gs, skel, cam, bg, device)
    o = cfg.opt
    flags = dict(warm=False, active_sh=SH_DEGREE, enable_to=True, enable_sm=True)
    lam = dict(lambda_template_offsets=o.lambda_template_offsets * 1e3, lambda_template_fixed=o.lambda_template_fixed)
    return gs, skel, cam, bg, fr, pre_d_xyz, pre_d_joints, cfg, flags, lam


def _raster_inputs(gs, skel, cam):
    """The serving avatar at t = 0.3 as rasterize_tiled's inputs: the
    deformed means (a leaf), SH-0 colours, opacity, scales and rotations."""
    import torch

    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.ops.quaternion import quat_normalize
    from riggs_tpu_torch.ops.sh import C0

    with torch.no_grad():
        d = SW.skeleton_forward(skel, gs.xyz, 0.3, gs.motion_mask)
        means = gs.xyz + d["d_xyz"]
        colors = torch.clamp(gs.get_features[:, 0, :] * C0 + 0.5, min=0.0)
        rots = quat_normalize(gs.rotation + d["d_rotation"])
    leaves = [means, gs.get_opacity[:, 0].detach(), gs.get_scaling.detach(), rots]
    return [x.clone().requires_grad_(True) for x in leaves], colors


def _raster_grad(fn, leaves, colors, weight):
    """The frame and the gradient of sum(image * weight) in the leaves."""
    import torch

    means, opacity, scales, rots = leaves
    out = fn(means, colors, opacity, scales, rots)
    grads = torch.autograd.grad((out["image"] * weight).sum(), leaves)
    return out["image"].detach(), grads


def _tileshard_work(cap, out_dir):
    """One rank's [tileshard] work (both ranks run it alike; see
    tileshard_phase)."""
    import torch

    from riggs_tpu_torch.data.dataset import SceneData
    from riggs_tpu_torch.parallel.mesh import make_mesh
    from riggs_tpu_torch.parallel.render import rasterize_tile_sharded
    from riggs_tpu_torch.parallel.stage2_dp import train_stage2_dp
    from riggs_tpu_torch.parallel.train import make_dp_stage2_step, stack_frames, stage2_flags
    from riggs_tpu_torch.render import blend
    from riggs_tpu_torch.render.tiles import rasterize_tiled
    from riggs_tpu_torch.train.stage2 import PretrainInfo, stage2_frame_loss, stage2_step

    res = {}
    gs, skel, cam, bg, fr, pre_d_xyz, pre_d_joints, cfg, flags, lam = _tileshard_inputs(DEVICE)
    tile, data = make_mesh(1, 2), make_mesh(2, 1)

    # rasterize_tile_sharded against rasterize_tiled on this process
    leaves, colors = _raster_inputs(gs, skel, cam)
    weight = torch.randn((SIZE, SIZE, 3), device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(5))
    single = lambda m, c, o, s, r: rasterize_tiled(cam, m, c, o, s, r, bg, alive=gs.alive, max_per_tile=cap)
    sharded = lambda m, c, o, s, r: rasterize_tile_sharded(tile, cam, m, c, o, s, r, bg, alive=gs.alive,
                                                           max_per_tile=cap)
    img1, g1 = _raster_grad(single, leaves, colors, weight)
    torch.cuda.synchronize()
    blend.reset_launches()
    img2, g2 = _raster_grad(sharded, leaves, colors, weight)
    torch.cuda.synchronize()
    res["render_launches"] = dict(blend.launches)
    res["render_same"] = [_same_bits(img2, img1)] + [_same_bits(a, b) for a, b in zip(g2, g1)]
    res["render_err"] = [float((img2 - img1).abs().max())] + [float((a - b).abs().max()) for a, b in zip(g2, g1)]
    res["render_ms"] = {"single": _host_ms(lambda: _raster_grad(single, leaves, colors, weight), 3),
                        "sharded": _host_ms(lambda: _raster_grad(sharded, leaves, colors, weight), 3)}

    # 5 single-device stage2_steps, then 5 dp steps at 1 x 2 (counted)
    kw = dict(use_chamfer=True, max_per_tile=cap, lambda_chamfer=cfg.opt.lambda_deformed_node_prjection, **flags)
    st1 = fresh_state(gs, skel, TRAIN_ITS[-1], DEVICE)
    losses1 = []
    t0 = time.perf_counter()
    for _ in range(TILESHARD_STEPS):
        st1, m = stage2_step(st1, fr, UID, bg, TILESHARD_LRS, 1e-4, pre_d_xyz[UID], pre_d_joints[UID], **lam, **kw)
        losses1.append(float(m["loss"]))
    torch.cuda.synchronize()
    res["single_ms"] = (time.perf_counter() - t0) / TILESHARD_STEPS * 1e3
    step = make_dp_stage2_step(tile, use_chamfer=True, lambda_chamfer=kw["lambda_chamfer"], max_per_tile=cap,
                               tile_parallel=True)
    batch = stack_frames([fr])
    uid = np.array([UID])

    def dp(st, step, batch, uids):
        return step(st, batch, uids, bg, TILESHARD_LRS, 1e-4, pre_d_xyz[uids], pre_d_joints[uids],
                    np.full(len(uids), lam["lambda_template_offsets"], np.float32),
                    np.full(len(uids), lam["lambda_template_fixed"], np.float32), stage2_flags(**flags))

    st2 = fresh_state(gs, skel, TRAIN_ITS[-1], DEVICE)
    losses2 = []
    torch.cuda.synchronize()
    blend.reset_launches()
    t0 = time.perf_counter()
    for _ in range(TILESHARD_STEPS):
        st2, m = dp(st2, step, batch, uid)
        losses2.append(float(m["loss"]))
    torch.cuda.synchronize()
    res["dp12_ms"] = (time.perf_counter() - t0) / TILESHARD_STEPS * 1e3
    res["dp12_launches"] = dict(blend.launches)
    res["dp12_losses"], res["single_losses"] = losses2, losses1
    res["dp12_vs_single"] = _state_diff(st2, st1)
    res["dp12_hash"] = _state_hash(st2)
    del st1, st2

    # 5 dp steps at 2 x 1: rank d takes frame d of the batch (uids 0 and 1)
    step21 = make_dp_stage2_step(data, use_chamfer=True, lambda_chamfer=kw["lambda_chamfer"], max_per_tile=cap)
    (f0, f1), uids = _dp21_frames(fr)
    st3 = fresh_state(gs, skel, TRAIN_ITS[-1], DEVICE)
    with torch.no_grad():  # the first step's loss: the mean of the two frames' losses
        params = {"gs": st3.gs.params_dict(), "skel": st3.skel.params_dict()}
        m2b = torch.zeros_like(gs.xyz[:, :2])
        want = sum(float(stage2_frame_loss(params, st3, f, u, bg, m2b, pre_d_xyz[u], pre_d_joints[u],
                                           lam["lambda_template_offsets"], lam["lambda_template_fixed"], **kw)[0])
                   for f, u in zip((f0, f1), uids)) / 2
    b2 = stack_frames([f0, f1])
    losses3 = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TILESHARD_STEPS):
        st3, m = dp(st3, step21, b2, uids)
        losses3.append(float(m["loss"]))
    torch.cuda.synchronize()
    res["dp21_ms"] = (time.perf_counter() - t0) / TILESHARD_STEPS * 1e3
    res["dp21_losses"], res["dp21_want"] = losses3, want
    res["dp21_hash"] = _state_hash(st3)
    if data.rank == 0:  # nccl_world_one holds it to the same steps on one rank
        res["dp21_leaves"] = {k: v.cpu() for k, v in _state_leaves(st3).items()}
    del st3

    # train_stage2_dp at 1 x 2: four frames, one test frame, a densification
    cfg.pipe.max_per_tile = cap
    for k, v in TILESHARD_SCHEDULE.items():
        setattr(cfg.opt, k, v)
    frames = [dataclasses.replace(fr, cam=dataclasses.replace(fr.cam, fid=torch.tensor(t, device=DEVICE)))
              for t in np.linspace(0.0, 1.0, N_FRAMES)]
    info = PretrainInfo(d_xyz=pre_d_xyz, d_joints=pre_d_joints, template_idx=UID, joints=skel.joints.cpu().numpy(),
                        parents=np.array(PARENTS), joint_node_indices=np.arange(len(PARENTS)))
    scene = SceneData(np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32), train_frames=frames,
                      test_frames=[fr], cameras_extent=1.0)
    events = []
    st0 = fresh_state(gs, skel, 0, DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st4, _, hist = train_stage2_dp(None, scene, cfg, tile, init=(st0, info, frames), log_every=5,
                                   test_every=TILESHARD_LOOP - 1, model_path=Path(out_dir) / "rig", events=events,
                                   device=DEVICE)
    torch.cuda.synchronize()
    res["loop_s"] = time.perf_counter() - t0
    res["loop_events"] = [{k: v for k, v in e.items() if k != "idx"} for e in events]
    res["loop_history"] = hist
    res["loop_hash"] = _state_hash(st4)
    res["loop_alive"] = int(st4.gs.num_alive)
    res["loop_finite"] = _finite(st4)
    del st4

    # train_stage2_dp at 2 x 1 with the tile ladder: fitted from the (B, T)
    # tile counts of the first 12 steps, the last two steps on it
    cfg.pipe.use_tile_ladder = True
    cfg.opt.iterations_stage2 = TILESHARD_LADDER_LOOP
    events = []
    st0 = fresh_state(gs, skel, 0, DEVICE)
    torch.cuda.synchronize()
    blend.reset_launches()
    t0 = time.perf_counter()
    st5, _, hist = train_stage2_dp(None, scene, cfg, data, init=(st0, info, frames), log_every=4, events=events,
                                   device=DEVICE)
    torch.cuda.synchronize()
    res["ladder_loop_s"] = time.perf_counter() - t0
    res["ladder_loop_launches"] = dict(blend.launches)
    res["ladder_loop_events"] = [{k: v for k, v in e.items() if k != "idx"} for e in events]
    res["ladder_loop_history"] = hist
    res["ladder_loop_hash"] = _state_hash(st5)
    res["ladder_loop_finite"] = _finite(st5)
    return res


def _finite(state):
    """Whether every floating leaf of a Stage2State is finite."""
    import torch

    return all(bool(torch.isfinite(v).all()) for v in _state_leaves(state).values() if v.is_floating_point())


def _dp21_frames(fr):
    """The 2 x 1 steps' two frames: the [train] frame (uid 0) and the same
    at t = 0.8 (uid 1), and their uids."""
    import torch

    fr1 = dataclasses.replace(fr, cam=dataclasses.replace(fr.cam, fid=torch.tensor(0.8, device=DEVICE)))
    return (fr, fr1), np.array([0, 1])


def _tileshard_rank(rank, world, port, cap, out_dir):
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TILESHARD_TIMEOUT))
    try:
        res = _tileshard_work(cap, out_dir)
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def tileshard_phase(cap):
    """[tileshard]: two processes on the one card (gloo with CUDA tensors:
    NCCL takes one rank per device), each building the full-width avatar
    and the [train] frame from their seeds: rasterize_tile_sharded on a
    1 x 2 mesh against rasterize_tiled on the same process (image and
    gradient bitwise); TILESHARD_STEPS make_dp_stage2_step steps at 1 x 2
    (tile-parallel, the counters zeroed just before and read just after:
    the offset entry's kernels and no plain blend) against as many
    single-device stage2_steps; as many at 2 x 1 (B = 2, the first loss the
    mean of the two frames', the state held by nccl_world_one to the same
    steps on one rank); train_stage2_dp at 1 x 2 for TILESHARD_LOOP
    iterations with a densification, a test evaluation and rank 0's
    checkpoint; train_stage2_dp at 2 x 1 with the tile ladder for
    TILESHARD_LADDER_LOOP iterations (the ladder fitted from the (B, T) tile
    counts, the permuted-gm kernels run on it); every state hashed equal on
    both ranks. Returns (the 1 x 2 steps' launch counters, the same per
    step, rank 0's results)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_tileshard_rank, args=(2, _free_port(), cap, out_dir), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + TILESHARD_TIMEOUT
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError(f"[tileshard] the two ranks did not finish in {TILESHARD_TIMEOUT} s")
        wall = time.perf_counter() - t0
        r0, r1 = (torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False) for r in range(2))
        ckpts = sorted(p.relative_to(out_dir).as_posix() for p in Path(out_dir).glob("rig/checkpoints/*/state.npz"))
    print(f"[tileshard] two gloo ranks on one card, {wall:.1f} s (spawn, set-up and every case)")
    for r, res in enumerate((r0, r1)):
        names = ("image", "d means3d", "d opacity", "d scales", "d rotations")
        if not all(res["render_same"]):
            raise RuntimeError(f"[tileshard] rank {r}: rasterize_tile_sharded differs from rasterize_tiled: "
                               + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, res["render_err"])))
        lc = res["render_launches"]
        if lc["blend_cm_offset"] != 1 or lc["blend_cm_offset_bwd"] != 1 or lc["blend_cm"] or lc["blend_cm_bwd"]:
            raise RuntimeError(f"[tileshard] rank {r}: the sharded frame's launches {lc}")
    print(f"[tileshard] rasterize_tile_sharded (1 x 2, {SIZE}x{SIZE}, {N_ALIVE} alive) vs rasterize_tiled: image and "
          f"gradients of means, opacity, scales and rotations bitwise equal on both ranks; forward + backward "
          f"{r0['render_ms']['sharded']:.2f} ms sharded vs {r0['render_ms']['single']:.2f} ms on one process")
    worst, same = r0["dp12_vs_single"]
    lc = r0["dp12_launches"]
    if not worst <= BWD_TOL:
        raise RuntimeError(f"[tileshard] 1 x 2 dp steps vs stage2_step: worst leaf {worst:.3e} > {BWD_TOL}")
    if lc["blend_cm"] or lc["blend_cm_bwd"] or lc["blend_cm_offset"] != TILESHARD_STEPS \
            or lc["blend_cm_offset_bwd"] != TILESHARD_STEPS:
        raise RuntimeError(f"[tileshard] the 1 x 2 dp steps' launches {lc}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0["dp12_losses"], r0["single_losses"]))
    if not loss_err <= 1e-5:
        raise RuntimeError(f"[tileshard] 1 x 2 losses {r0['dp12_losses']} vs {r0['single_losses']}")
    print(f"[tileshard] make_dp_stage2_step 1 x 2 (tile-parallel), {TILESHARD_STEPS} steps at it={TRAIN_ITS[-1]}: "
          f"losses {', '.join(f'{v:.6f}' for v in r0['dp12_losses'])} vs stage2_step's (max rel {loss_err:.2e}); "
          f"state vs stage2_step's: worst leaf max|d| / max|leaf| {worst:.2e}, bitwise {same}; "
          f"{r0['dp12_ms']:.2f} ms per step vs {r0['single_ms']:.2f} ms on one process; launches {lc}")
    rel21 = abs(r0["dp21_losses"][0] - r0["dp21_want"]) / abs(r0["dp21_want"])
    if not rel21 <= 1e-5 or not all(np.isfinite(r0["dp21_losses"])):
        raise RuntimeError(f"[tileshard] 2 x 1 first loss {r0['dp21_losses'][0]} vs the frames' mean {r0['dp21_want']}")
    print(f"[tileshard] make_dp_stage2_step 2 x 1 (B = 2), {TILESHARD_STEPS} steps: losses "
          f"{', '.join(f'{v:.6f}' for v in r0['dp21_losses'])}, the first vs the two frames' mean loss rel {rel21:.2e}; "
          f"{r0['dp21_ms']:.2f} ms per step")
    ev = [e["event"] for e in r0["loop_events"]]
    if not r0["loop_finite"] or "fps reset" not in ev or "gs densify" not in ev or "test" not in ev:
        raise RuntimeError(f"[tileshard] train_stage2_dp: finite {r0['loop_finite']}, events {ev}")
    if ckpts != [f"rig/checkpoints/iteration_{TILESHARD_LOOP - 1}/state.npz"]:
        raise RuntimeError(f"[tileshard] train_stage2_dp's checkpoints {ckpts}: one, by rank 0")
    test = next(e for e in r0["loop_events"] if e["event"] == "test")
    print(f"[tileshard] train_stage2_dp 1 x 2, {TILESHARD_LOOP} iterations: {r0['loop_s']:.1f} s "
          f"({r0['loop_s'] / TILESHARD_LOOP * 1e3:.1f} ms per iteration with the events); events {ev}; "
          f"{r0['loop_alive']} alive; loss {', '.join(f'{it}: {m['loss']:.5f}' for it, m in r0['loop_history'])}; "
          f"test psnr {test['psnr']:.3f}; one checkpoint, rank 0's")
    ev = [e["event"] for e in r0["ladder_loop_events"]]
    llc = r0["ladder_loop_launches"]
    if not r0["ladder_loop_finite"] or ev[:3] != ["fps reset", "gs densify", "ladder fit"] \
            or set(ev[3:]) - {"ladder refit"} or not llc["blend_permuted_gm"] or not llc["blend_permuted_gm_bwd"] or llc["blend_cm_offset"]:
        raise RuntimeError(f"[tileshard] train_stage2_dp 2 x 1 with the ladder: finite {r0['ladder_loop_finite']}, "
                           f"events {ev}, launches {llc}")
    fit = next(e for e in r0["ladder_loop_events"] if e["event"] == "ladder fit")
    print(f"[tileshard] train_stage2_dp 2 x 1 with the tile ladder, {TILESHARD_LADDER_LOOP} iterations: "
          f"{r0['ladder_loop_s']:.1f} s ({r0['ladder_loop_s'] / TILESHARD_LADDER_LOOP * 2e3:.1f} ms per step of B = 2 "
          f"with the events); events {ev}, the ladder {fit['ladder']} fitted at it={fit['it']}; loss "
          f"{', '.join(f'{it}: {m['loss']:.5f}' for it, m in r0['ladder_loop_history'])}; launches {llc}")
    for key in ("dp12_hash", "dp21_hash", "loop_hash", "ladder_loop_hash"):
        if r0[key] != r1[key]:
            raise RuntimeError(f"[tileshard] {key}: the ranks' states differ")
    print("[tileshard] the states hash equal on both ranks after the 1 x 2 steps, the 2 x 1 steps and both loops")
    launches_per_step = {k: v / TILESHARD_STEPS for k, v in lc.items()}
    return lc, launches_per_step, r0


def nccl_world_one(cap, dp21_leaves):
    """[tileshard], NCCL: a one-rank NCCL group in this process, a 1 x 1
    mesh: rasterize_tile_sharded and a tile-parallel make_dp_stage2_step
    against rasterize_tiled and stage2_step, bitwise; then TILESHARD_STEPS
    dp steps of B = 2 on this one rank (both frames' gradients summed by
    autograd, no collective that matters) from the state the 2 x 1 steps
    started from: the two ranks' state after those steps (``dp21_leaves``,
    rank 0's) must match it within BWD_TOL, so a missing, doubled or
    unscaled sum over the data group fails."""
    import datetime

    import torch
    import torch.distributed as dist

    from riggs_tpu_torch.parallel.mesh import make_mesh
    from riggs_tpu_torch.parallel.render import rasterize_tile_sharded
    from riggs_tpu_torch.parallel.train import make_dp_stage2_step, stack_frames, stage2_flags
    from riggs_tpu_torch.render.tiles import rasterize_tiled
    from riggs_tpu_torch.train.stage2 import stage2_step

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120), device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh(1, 1)
        gs, skel, cam, bg, fr, pre_d_xyz, pre_d_joints, cfg, flags, lam = _tileshard_inputs(DEVICE)
        leaves, colors = _raster_inputs(gs, skel, cam)
        weight = torch.randn((SIZE, SIZE, 3), device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(5))
        img1, g1 = _raster_grad(lambda m, c, o, s, r: rasterize_tiled(cam, m, c, o, s, r, bg, alive=gs.alive,
                                                                     max_per_tile=cap), leaves, colors, weight)
        img2, g2 = _raster_grad(lambda m, c, o, s, r: rasterize_tile_sharded(mesh, cam, m, c, o, s, r, bg,
                                                                            alive=gs.alive, max_per_tile=cap),
                                leaves, colors, weight)
        kw = dict(use_chamfer=True, max_per_tile=cap, lambda_chamfer=cfg.opt.lambda_deformed_node_prjection, **flags)
        st1, _ = stage2_step(fresh_state(gs, skel, TRAIN_ITS[-1], DEVICE), fr, UID, bg, TILESHARD_LRS, 1e-4,
                             pre_d_xyz[UID], pre_d_joints[UID], **lam, **kw)
        step = make_dp_stage2_step(mesh, use_chamfer=True, lambda_chamfer=kw["lambda_chamfer"], max_per_tile=cap,
                                   tile_parallel=True)
        uid = np.array([UID])
        st2, _ = step(fresh_state(gs, skel, TRAIN_ITS[-1], DEVICE), stack_frames([fr]), uid, bg, TILESHARD_LRS, 1e-4,
                      pre_d_xyz[uid], pre_d_joints[uid], np.array([lam["lambda_template_offsets"]], np.float32),
                      np.array([lam["lambda_template_fixed"]], np.float32), stage2_flags(**flags))
        torch.cuda.synchronize()
        same = [_same_bits(img2, img1)] + [_same_bits(a, b) for a, b in zip(g2, g1)]
        worst, state_same = _state_diff(st2, st1)
        if not all(same) or not worst <= BWD_TOL:
            raise RuntimeError(f"[tileshard] NCCL 1 x 1: frame and gradients bitwise {same}, state worst {worst:.3e}")
        print(f"[tileshard] NCCL, one rank ({mesh.backend}, 1 x 1 mesh): rasterize_tile_sharded's frame and gradients "
              f"bitwise equal to rasterize_tiled's; one tile-parallel dp step vs stage2_step: worst leaf "
              f"{worst:.2e}, bitwise {state_same}")
        del st1, st2
        step = make_dp_stage2_step(mesh, use_chamfer=True, lambda_chamfer=kw["lambda_chamfer"], max_per_tile=cap)
        (f0, f1), uids = _dp21_frames(fr)
        b2 = stack_frames([f0, f1])
        st3 = fresh_state(gs, skel, TRAIN_ITS[-1], DEVICE)
        for _ in range(TILESHARD_STEPS):
            st3, _ = step(st3, b2, uids, bg, TILESHARD_LRS, 1e-4, pre_d_xyz[uids], pre_d_joints[uids],
                          np.full(2, lam["lambda_template_offsets"], np.float32),
                          np.full(2, lam["lambda_template_fixed"], np.float32), stage2_flags(**flags))
        worst, same = _leaves_diff({k: v.to(DEVICE) for k, v in dp21_leaves.items()}, _state_leaves(st3))
        if not worst <= BWD_TOL:
            raise RuntimeError(f"[tileshard] 2 x 1 dp steps vs B = 2 on one rank: worst leaf {worst:.3e} > {BWD_TOL}")
        print(f"[tileshard] make_dp_stage2_step 2 x 1 (two gloo ranks) vs B = 2 on one rank (NCCL 1 x 1), "
              f"{TILESHARD_STEPS} steps: worst leaf max|d| / max|leaf| {worst:.2e}, bitwise {same}")
    finally:
        dist.destroy_process_group()


# [dp1]: the frame-parallel stage-1 and static steps and train_stage1_dp
# on two gloo ranks on the card, from [stage1]'s state (its make_phase_b_auto
# steps' it = 5000 for the steps); the loop from it = 0 over DP1_LOOP
# iterations of B = 2 with the ladder (fitted after LadderPolicy's 12 probe
# steps, the last two steps on it), a forced node densify/prune at 8, a
# Gaussian densification at 12 and an opacity reset at 16
DP1_STEPS = 5
DP1_LOOP = 28
DP1_SCHEDULE = dict(iterations=DP1_LOOP, warm_up=4, node_force_densify_prune_step=9, densify_from_iter=10,
                    densify_until_iter=14, densification_interval=4, opacity_reset_interval=16)
DP1_TIMES = (0.5, 0.8, 0.4, 0.6)  # the loop's frames (the [train] frame at these times); a batch: the first two
DP1_STATIC_LR = 1e-4
DP1_SYNC_LOOP = 14  # the NCCL rank's loop under the sync counter: B = 1, 12 probe steps, two on the ladder
DP1_TIMEOUT = 600


def _stage1_leaves(state):
    """A Stage1State's tensors by path."""
    from riggs_tpu_torch.train.optim import tree_leaves

    out = {}
    for name, tree in (("gs", (state.gs.params_dict(), state.gs.alive)), ("node_gs", state.node_gs.params_dict()),
                       ("warp", state.warp.params_dict()),
                       ("opt_gs", (state.opt_gs.mu, state.opt_gs.nu, state.opt_gs.count)),
                       ("opt_warp", (state.opt_warp.mu, state.opt_warp.nu, state.opt_warp.count)),
                       ("stats", dataclasses.astuple(state.stats_gs)), ("it", state.it)):
        for i, v in enumerate(tree_leaves(tree)):
            out[f"{name}.{i}"] = v.detach()
    return out


def _static_leaves(state):
    from riggs_tpu_torch.train.optim import tree_leaves

    return {f"{i}": v.detach() for i, v in enumerate(tree_leaves((state.gs.params_dict(), state.opt.mu, state.opt.nu,
                                                                   state.opt.count)))}


def _dp1_inputs():
    """[stage1]'s initial state and window from the seeds (build_avatar,
    the [train] frame, stage1_setup), the batch's two frames and the loop's
    scene."""
    import torch

    from riggs_tpu_torch.data.dataset import SceneData

    gs, skel, cam, bg = build_avatar(0, N_ALIVE, CAPACITY, SIZE, DEVICE)
    fr = build_training(gs, skel, cam, bg, DEVICE)[0]
    cfg, state0, cap1, _, _ = stage1_setup(gs, bg, fr)
    frames = [dataclasses.replace(fr, cam=dataclasses.replace(fr.cam, fid=torch.tensor(t, device=DEVICE)))
              for t in DP1_TIMES]
    scene = SceneData(np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32), train_frames=frames,
                      cameras_extent=1.0)
    return cfg, state0, cap1, frames, scene, bg


def _dp1_steps(mesh, cfg, state0, frames, bg, cap):
    """DP1_STEPS make_dp_stage1_step steps of B = 2 (the first two frames)
    at it = STAGE1_ITS[-1] from state0 (a copy), the ARAP sample times drawn
    from a seeded generator (the same on every rank), then as many
    make_dp_static_step steps on the Gaussians (the second frame's image
    flipped upside down); the counters zeroed just before the stage-1
    steps and read just after. Returns (the stage-1 state, its losses, ms
    a step, the launches, the static state, its losses)."""
    import torch

    from riggs_tpu_torch.models import node_warp as NW
    from riggs_tpu_torch.ops import geometry as GEO
    from riggs_tpu_torch.parallel.train import make_dp_stage1_step, make_dp_static_step, stack_frames, stage1_flags
    from riggs_tpu_torch.render import blend
    from riggs_tpu_torch.train import schedule as S
    from riggs_tpu_torch.train.stage1 import stage1_lr_fns
    from riggs_tpu_torch.train.static import TrainState

    it, o = STAGE1_ITS[-1], cfg.opt
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    arap = [torch.stack([NW.arap_sample_times(gen, device=DEVICE) for _ in range(2)]) for _ in range(DP1_STEPS)]
    f32 = lambda d: {k: float(np.float32(v)) for k, v in d.items()}
    gauss_lrs, warp_lrs = stage1_lr_fns(cfg)
    lam = (float(np.float32(S.landmark_interpolate(NW.LAMBDA_ARAP_LANDMARKS, NW.LAMBDA_ARAP_STEPS, it))),
           float(np.float32(S.landmark_interpolate(o.lambda_motion_mask_landmarks, o.lambda_motion_mask_steps, it,
                                                   interpolation="log"))))
    step = make_dp_stage1_step(mesh, use_chamfer=True, use_motion_loss=True,
                               lambda_chamfer=o.lambda_deformed_node_prjection, max_per_tile=cap)
    batch = stack_frames(frames[:2])
    flags = stage1_flags(warm=False, active_sh=min(it // o.oneupSHdegree_step, SH_DEGREE))
    st, losses = copy.deepcopy(state0), []
    torch.cuda.synchronize()
    blend.reset_launches()
    GEO.reset_launches()
    t0 = time.perf_counter()
    for k in range(DP1_STEPS):
        st, m = step(st, batch, bg, f32(gauss_lrs(it)), f32(warp_lrs(it)), arap[k], *lam, np.zeros(2, np.float32),
                     flags)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / DP1_STEPS * 1e3
    launches = dict(blend.launches, **GEO.launches)
    static = make_dp_static_step(mesh, active_sh=SH_DEGREE, max_per_tile=cap)
    flipped = dataclasses.replace(frames[1], image=torch.flip(frames[1].image, dims=(0,)))
    sbatch = stack_frames([frames[0], flipped])
    s0 = copy.deepcopy(state0)
    ss, slosses = TrainState(gs=s0.gs, opt=s0.opt_gs, stats=s0.stats_gs), []
    for _ in range(DP1_STEPS):
        ss, loss = static(ss, sbatch, bg, DP1_STATIC_LR)
        slosses.append(loss)
    return st, [float(v) for v in losses], ms, launches, ss, [float(v) for v in slosses]


def _dp1_loop_cfg(cfg, cap, schedule):
    cfg = copy.deepcopy(cfg)
    cfg.pipe.max_per_tile = cap
    for k, v in schedule.items():
        setattr(cfg.opt, k, v)
    return cfg


def _dp1_work():
    """One rank's [dp1] work (both ranks run it alike; see dp1_phase)."""
    import torch

    from riggs_tpu_torch.ops import geometry as GEO
    from riggs_tpu_torch.parallel.mesh import make_mesh
    from riggs_tpu_torch.parallel.stage1_dp import train_stage1_dp
    from riggs_tpu_torch.render import blend

    cfg, state0, cap, frames, scene, bg = _dp1_inputs()
    mesh = make_mesh(2, 1)
    res = {"init_hash": _leaves_hash(_stage1_leaves(state0)), "cap": cap}
    st, res["losses"], res["ms"], res["launches"], ss, res["static_losses"] = _dp1_steps(mesh, cfg, state0, frames,
                                                                                         bg, cap)
    leaves, sleaves = _stage1_leaves(st), _static_leaves(ss)
    res["hash"], res["static_hash"] = _leaves_hash(leaves), _leaves_hash(sleaves)
    res["finite"] = all(bool(torch.isfinite(v).all()) for v in leaves.values() if v.is_floating_point())
    if mesh.rank == 0:  # dp1_world_one holds them to the same steps on one rank
        res["leaves"] = {k: v.cpu() for k, v in leaves.items()}
        res["static_leaves"] = {k: v.cpu() for k, v in sleaves.items()}
    del st, ss
    events, calls = [], []
    torch.cuda.synchronize()
    blend.reset_launches()
    GEO.reset_launches()
    t0 = time.perf_counter()
    state, hist = train_stage1_dp(scene, _dp1_loop_cfg(cfg, cap, DP1_SCHEDULE), mesh, seed=0, log_every=4,
                                  init=copy.deepcopy(state0), events=events,
                                  step_callback=lambda s_, it: calls.append((it, time.perf_counter())),
                                  device=DEVICE)
    torch.cuda.synchronize()
    res["loop_s"] = time.perf_counter() - t0
    res["loop_launches"] = dict(blend.launches, **GEO.launches)
    res["loop_events"], res["loop_history"] = events, hist
    res["loop_its"] = [it for it, _ in calls]
    d = np.diff([t for _, t in calls]) * 1e3
    res["loop_ms"] = float(np.median(d))
    leaves = _stage1_leaves(state)
    res["loop_hash"] = _leaves_hash(leaves)
    res["loop_finite"] = all(bool(torch.isfinite(v).all()) for v in leaves.values() if v.is_floating_point())
    res["loop_nodes"], res["loop_alive"] = state.warp.node_num, int(state.gs.num_alive)
    return res


def _dp1_rank(rank, world, port, out_dir):
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DP1_TIMEOUT))
    try:
        torch.save(_dp1_work(), Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp1_phase():
    """[dp1]: two processes on the one card (gloo with CUDA tensors), each
    building [stage1]'s initial state from the seeds (full width: the
    avatar's 100000 alive of 131072 slots, 512 nodes, 800x800):
    DP1_STEPS make_dp_stage1_step steps at 2 x 1 (B = 2, it = 5000, the
    counters zeroed just before and read just after: the blend kernels and
    estimate_rotations, one fit a frame) and as many make_dp_static_step
    steps; train_stage1_dp at 2 x 1 for DP1_LOOP iterations with the
    ladder, a node densify/prune, a Gaussian densification and an opacity
    reset; every state hashed equal on both ranks. Two ranks on one card are
    a correctness path: their times say nothing of two cards. Returns rank
    0's results (the counted launches of its dp steps among them)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_dp1_rank, args=(2, _free_port(), out_dir), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + DP1_TIMEOUT
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError(f"[dp1] the two ranks did not finish in {DP1_TIMEOUT} s")
        wall = time.perf_counter() - t0
        r0, r1 = (torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False) for r in range(2))
    print(f"[dp1] two gloo ranks on one card, {wall:.1f} s (spawn, set-up and every case); a correctness path: "
          "two ranks share one card, so no time here is a time on two cards")
    for r, res in enumerate((r0, r1)):
        lc = res["launches"]
        if not res["finite"] or lc["estimate_rotations"] != DP1_STEPS or not lc["blend_cm"] or not lc["blend_cm_bwd"]:
            raise RuntimeError(f"[dp1] rank {r}: finite {res['finite']}, launches of the dp steps {lc}")
        print(f"[dp1] rank {r}: make_dp_stage1_step 2 x 1 (B = 2, it={STAGE1_ITS[-1]}), {DP1_STEPS} steps: losses "
              f"{', '.join(f'{v:.6f}' for v in res['losses'])}; {res['ms']:.2f} ms a step; launches {lc}")
    for key in ("init_hash", "hash", "static_hash", "loop_hash"):
        if r0[key] != r1[key]:
            raise RuntimeError(f"[dp1] {key}: the ranks' states differ")
    ev = [(e["it"], e["event"]) for e in r0["loop_events"]]
    kinds = {e for _, e in ev}
    if not r0["loop_finite"] or not {"node densify/prune", "gs densify", "opacity reset", "ladder fit"} <= kinds \
            or r0["loop_its"] != list(range(0, DP1_LOOP, 2)):
        raise RuntimeError(f"[dp1] train_stage1_dp: finite {r0['loop_finite']}, events {ev}, steps {r0['loop_its']}")
    llc = r0["loop_launches"]
    if llc["estimate_rotations"] < DP1_LOOP // 2 or not llc["blend_permuted_gm"] or not llc["blend_permuted_gm_bwd"]:
        raise RuntimeError(f"[dp1] train_stage1_dp's launches {llc}")
    print(f"[dp1] make_dp_static_step 2 x 1, {DP1_STEPS} steps: losses "
          f"{', '.join(f'{v:.6f}' for v in r0['static_losses'])}")
    print(f"[dp1] train_stage1_dp 2 x 1 with the tile ladder, {DP1_LOOP} iterations: {r0['loop_s']:.1f} s, "
          f"{r0['loop_ms']:.1f} ms a step of B = 2 (median); events {ev}; {r0['loop_nodes']} nodes, "
          f"{r0['loop_alive']} alive; loss {', '.join(f'{it}: {m['loss']:.5f}' for _, it, m in r0['loop_history'])}; "
          f"launches {llc}")
    print("[dp1] the states hash equal on both ranks: the initial state, after the stage-1 and the static dp steps, "
          "after the loop")
    return r0


def dp1_world_one(r0):
    """[dp1], NCCL: a one-rank NCCL group in this process, a 1 x 1 mesh:
    the same DP1_STEPS stage-1 and static dp steps of B = 2 on this one rank
    from the same initial state (hashed equal to the ranks'), the two
    ranks' states held to them (<= 1e-6 of each leaf's largest |value|,
    expected bitwise) and the step times beside the two ranks'; then one
    dp stage-1 step under the sync audit (no host read), and
    DP1_SYNC_LOOP iterations of train_stage1_dp (B = 1, no event but the
    ladder fit) under the sync counter: one read a step, the batch's
    overflow, and the (B, T) tile counts of the steps the ladder policy
    observes, by the reference's design, besides the frame sampler's
    set-up (a frame's time, once). Returns the loop's reads."""
    import datetime

    import torch
    import torch.distributed as dist

    from riggs_tpu_torch.parallel.mesh import make_mesh
    from riggs_tpu_torch.parallel.stage1_dp import train_stage1_dp
    from riggs_tpu_torch.train.sampling import FrameSampler

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120), device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh(1, 1)
        cfg, state0, cap, frames, scene, bg = _dp1_inputs()
        if _leaves_hash(_stage1_leaves(state0)) != r0["init_hash"]:
            raise RuntimeError("[dp1] NCCL 1 x 1: the initial state differs from the ranks'")
        st, losses, ms, _, ss, slosses = _dp1_steps(mesh, cfg, state0, frames, bg, cap)
        res = {}
        for name, got, want in (("stage-1", r0["leaves"], _stage1_leaves(st)),
                                ("static", r0["static_leaves"], _static_leaves(ss))):
            worst, same = _leaves_diff({k: v.to(DEVICE) for k, v in got.items()}, want)
            res[name] = (worst, same)
            if not worst <= 1e-6:
                raise RuntimeError(f"[dp1] {name} dp steps 2 x 1 vs B = 2 on one rank: worst leaf {worst:.3e} > 1e-6")
        print(f"[dp1] NCCL, one rank ({mesh.backend}, 1 x 1 mesh), the same initial state: the 2 x 1 states (two "
              f"gloo ranks) vs {DP1_STEPS} steps of B = 2 on one rank: stage-1 worst leaf max|d| / max|leaf| "
              f"{res['stage-1'][0]:.2e}, bitwise {res['stage-1'][1]}; static {res['static'][0]:.2e}, bitwise "
              f"{res['static'][1]}; losses {', '.join(f'{v:.6f}' for v in losses)}; {ms:.2f} ms a step of B = 2 "
              f"on one process vs {r0['ms']:.2f} on two ranks")
        del st, ss
        one = _dp1_steps_one(mesh, cfg, state0, frames, bg, cap)
        sync_audit(f"make_dp_stage1_step (NCCL 1 x 1, B = 2, it={STAGE1_ITS[-1]})", one)
        sync_cfg = _dp1_loop_cfg(cfg, cap, dict(iterations=DP1_SYNC_LOOP, warm_up=0,
                                                node_force_densify_prune_step=10 ** 9, densify_from_iter=10 ** 9,
                                                opacity_reset_interval=10 ** 9))
        dp_scene = dataclasses.replace(scene, train_frames=frames[:1])
        init = copy.deepcopy(state0)
        sites, callers, dtoh, syncs, _ = count_syncs(
            lambda: train_stage1_dp(dp_scene, sync_cfg, mesh, seed=0, init=init, device=DEVICE))
        over = _site(train_stage1_dp, 'int(metrics["overflow_tiles"])')
        counts = _site(train_stage1_dp, 'metrics["tile_counts"].cpu()')
        setup = _site(FrameSampler.__init__, "float(f.fid)")
        found = {k: (v, callers.get(k, "")) for k, v in sites.items()}
        print(f"[sync] train_stage1_dp (NCCL 1 x 1, B = 1, {DP1_SYNC_LOOP} steps, no event but the ladder fit): "
              f"{dtoh} device-to-host copies, {syncs} stream synchronizations, {found}")
        # the sync debug mode's warnings count every read; the profiler's
        # records corroborate them, though it may drop a copy's record
        if set(sites) - {over, counts, setup} or sites.get(over) != DP1_SYNC_LOOP or sites.get(counts, 0) < 12 \
                or sites.get(setup, 0) > len(dp_scene.train_frames) or syncs != sum(sites.values()) or dtoh > syncs:
            raise RuntimeError(f"[sync] train_stage1_dp: reads {found}, {dtoh} copies, {syncs} syncs; expected one "
                               f"a step at {over}, the observed tile counts at {counts} and the frame sampler's "
                               f"set-up at {setup}")
        return sites
    finally:
        dist.destroy_process_group()


def _dp1_steps_one(mesh, cfg, state0, frames, bg, cap):
    """A function making one more make_dp_stage1_step step of B = 2 at
    it = STAGE1_ITS[-1] from a copy of state0 (for the sync audit), called
    once here."""
    import torch

    from riggs_tpu_torch.models import node_warp as NW
    from riggs_tpu_torch.parallel.train import make_dp_stage1_step, stack_frames, stage1_flags
    from riggs_tpu_torch.train.stage1 import phase_b_flags, stage1_lr_fns

    it, o = STAGE1_ITS[-1], cfg.opt
    step = make_dp_stage1_step(mesh, use_chamfer=True, use_motion_loss=True,
                               lambda_chamfer=o.lambda_deformed_node_prjection, max_per_tile=cap)
    batch = stack_frames(frames[:2])
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    gauss_lrs, warp_lrs = stage1_lr_fns(cfg)
    fl = phase_b_flags(cfg, it)
    flags = stage1_flags(warm=False, active_sh=min(it // o.oneupSHdegree_step, SH_DEGREE))

    st = copy.deepcopy(state0)

    def one():
        nonlocal st
        arap = torch.stack([NW.arap_sample_times(gen, device=DEVICE) for _ in range(2)])
        st, _ = step(st, batch, bg, gauss_lrs(it), warp_lrs(it), arap, fl["lambda_arap"], fl["lambda_motion"],
                     np.zeros(2, np.float32), flags)

    one()  # warm-up
    return one



# ---------------------------------------------------------------------------
# [multihost]: the multi-process launch, the sharded checkpoints and the twins
# ---------------------------------------------------------------------------

MH_STEPS = 3  # dp stage-2 steps of B = 2, fed through global_batch and through shard_batch
MH_TIMEOUT = 600
MH_ITERS = 5  # the scaling twin's timed steps a size
# the pipeline twin's --dp 2: [cli]'s half depth (every count and interval
# halved, so every event still fires), to pay for the ranks running alone
# before the twins; its test cadence even, since the two-rank loop
# advances two iterations a step
MH_CLI_SCHEDULE = CLI_RUN_SCHEDULE
MH_TEST_EVERY = CLI_RUN_TEST_EVERY


def _multihost_rank(rank, world, port, cap, out_dir):
    """One rank of [multihost]: torchrun's environment (two ranks on this
    host), then init_distributed, which picks gloo for two ranks on one card
    and makes the card current."""
    import os

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch.distributed as dist

    from riggs_tpu_torch.parallel.multihost import init_distributed

    if not init_distributed():
        raise RuntimeError("[multihost] init_distributed found no group in torchrun's environment")
    try:
        torch.save(_multihost_work(cap, out_dir), Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _multihost_work(cap, out_dir):
    """One rank's [multihost] work: the host mesh; MH_STEPS full-width dp
    stage-2 steps at 2 x 1 fed by host_local_frames + global_batch, and the
    same fed by the whole stack (shard_batch); the first fed state saved
    with the sharded pair."""
    import torch
    import torch.distributed as dist

    from riggs_tpu_torch.io.checkpoint import save_checkpoint_sharded
    from riggs_tpu_torch.parallel.mesh import shard_batch
    from riggs_tpu_torch.parallel.multihost import global_batch, host_local_frames, make_host_mesh
    from riggs_tpu_torch.parallel.train import make_dp_stage2_step, stack_frames, stage2_flags

    res = {}
    gs, skel, cam, bg, fr, pre_d_xyz, pre_d_joints, cfg, flags, lam = _tileshard_inputs(DEVICE)
    mesh = make_host_mesh(tile=1)
    res["mesh"] = (dict(mesh.shape), mesh.data, mesh.backend, torch.cuda.current_device())
    frames = [dataclasses.replace(fr, cam=dataclasses.replace(fr.cam, fid=torch.tensor(t, device=DEVICE)))
              for t in np.linspace(0.0, 1.0, N_FRAMES)]
    step = make_dp_stage2_step(mesh, use_chamfer=True, lambda_chamfer=cfg.opt.lambda_deformed_node_prjection,
                               max_per_tile=cap)
    local, idx = host_local_frames(frames, batch=2, step=0, mesh=mesh)
    whole = stack_frames([frames[i] for i in idx])
    gb, sb = global_batch(stack_frames(local), mesh), shard_batch(whole, mesh)
    res["global_is_shard"] = all(_same_bits(getattr(gb.tree, k), getattr(sb, k)) for k in ("image", "alpha_mask"))

    def run(feed):
        st = fresh_state(gs, skel, TRAIN_ITS[-1], DEVICE)
        losses, picks = [], []
        for s in range(MH_STEPS):
            if s == 1:  # time the steps after the first
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            local, idx = host_local_frames(frames, batch=2, step=s, mesh=mesh)
            batch = (global_batch(stack_frames(local), mesh) if feed == "global"
                     else stack_frames([frames[i] for i in idx]))
            st, m = step(st, batch, idx, bg, TILESHARD_LRS, 1e-4, pre_d_xyz[idx], pre_d_joints[idx],
                         np.full(2, lam["lambda_template_offsets"], np.float32),
                         np.full(2, lam["lambda_template_fixed"], np.float32), stage2_flags(**flags))
            losses.append(float(m["loss"]))
            picks.append(idx.tolist())
        torch.cuda.synchronize()
        return st, losses, picks, (time.perf_counter() - t0) / (MH_STEPS - 1) * 1e3

    st, res["losses"], res["picks"], res["ms"] = run("global")
    res["hash"], res["finite"] = _state_hash(st), _finite(st)
    _, res["shard_losses"], _, res["shard_ms"] = st2 = run("shard")
    res["shard_hash"] = _state_hash(st2[0])
    del st2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res["save_bytes"] = save_checkpoint_sharded(Path(out_dir) / "mh", MH_STEPS, st, mesh=mesh)
    res["save_s"] = time.perf_counter() - t0
    res["rank"] = dist.get_rank()
    return res


def _start(cmds):
    """Start the commands (one process each, each in a session of its own,
    so that _kill reaches the ranks they spawn) from the repository's root."""
    root = Path(__file__).resolve().parent
    return [subprocess.Popen(c, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             start_new_session=True) for c in cmds]


def _kill(procs):
    """Kill started processes and everything they spawned."""
    import os
    import signal

    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()


def _finish(procs, timeout):
    """Wait for started processes; their (exit code, stdout, stderr). What
    is still running at ``timeout`` is killed."""
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        _kill(procs)
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def _twin_commands(out_dir):
    """[multihost]'s twins: scripts/torch_run_pipeline.py --synthetic --dp 2
    at MH_CLI_SCHEDULE, scripts/torch_multihost_smoke.py static and --stage2
    (two processes each, the reference's flags), and
    scripts/torch_scaling_bench.py --ranks 2, in that order."""
    root, py = Path(__file__).resolve().parent, sys.executable
    pipe = [py, str(root / "scripts" / "torch_run_pipeline.py"), "--synthetic", "--model_path", str(out_dir),
            "--test_every", str(MH_TEST_EVERY), "--dp", "2"]
    for k, v in MH_CLI_SCHEDULE.items():
        pipe += [f"--{k}", str(v)]
    smokes = []
    for mode in ("static", "--stage2"):
        port = _free_port()
        smokes += [[py, str(root / "scripts" / "torch_multihost_smoke.py"), "--process_id", str(r), "--coordinator",
                    f"127.0.0.1:{port}"] + ([mode] if mode != "static" else []) for r in range(2)]
    scaling = [py, str(root / "scripts" / "torch_scaling_bench.py"), "--ranks", "2", "--iters", str(MH_ITERS)]
    return [pipe] + smokes + [scaling]


def check_twins(runs, out_dir):
    """The twins' outcomes (_twin_commands' order): the smokes print the
    reference's line from process 0 only; the pipeline writes exactly a
    one-process run's files, from rank 0, prints each line once, and its
    rig reloads as scripts/torch_render_rig.py loads it; the scaling twin
    prints a line for data = 1 and 2."""
    import importlib.util

    from riggs_tpu_torch.data.synthetic import make_scene_data
    from riggs_tpu_torch.train.config import Config

    (rc, out, err), smokes, (src, sout, serr) = runs[0], runs[1:5], runs[5]
    for mode, ((rc0, o0, e0), (rc1, o1, e1)) in zip(("static", "--stage2"), (smokes[:2], smokes[2:])):
        line = [l for l in o0.splitlines() if l.startswith("MULTIHOST OK")]
        if rc0 or rc1 or not line or not line[0].endswith("procs=2") or o1.strip():
            raise RuntimeError(f"[multihost] torch_multihost_smoke.py {mode}: exits {rc0} {rc1}\n{o0[-2000:]}\n"
                               f"{e0[-3000:]}\n{o1[-1000:]}\n{e1[-3000:]}")
        print(f"[multihost] torch_multihost_smoke.py {mode}, two processes on the card: {line[0]}")
    if rc:
        raise RuntimeError(f"[multihost] torch_run_pipeline.py --dp 2 failed:\n{out[-3000:]}\n{err[-3000:]}")
    n = MH_CLI_SCHEDULE["iterations"]
    want = sorted(["cfg.json", "skeleton_tree.npz", "skeleton.obj", "numerical_res.txt",
                   f"checkpoints/iteration_{n}/state.npz", f"point_cloud/iteration_{n}/point_cloud.ply",
                   f"rig/checkpoints/iteration_{MH_TEST_EVERY}/state.npz", f"rig/checkpoints/iteration_{n}/state.npz",
                   f"rig/point_cloud/iteration_{MH_TEST_EVERY}/point_cloud.ply",
                   f"rig/point_cloud/iteration_{n}/point_cloud.ply", "rig/cfg.json"])
    files = sorted(p.relative_to(out_dir).as_posix() for p in out_dir.rglob("*") if p.is_file())
    once = all(out.count(s) == 1 for s in ("scene:", "stage 1 done", "stage 2 done", "test metrics:"))
    if files != want or not once:
        raise RuntimeError(f"[multihost] torch_run_pipeline.py --dp 2 wrote {files} (want {want}); "
                           f"each line once from rank 0: {once}\n{out[-2000:]}")
    root = Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location("torch_render_rig", root / "scripts" / "torch_render_rig.py")
    rr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rr)
    cfg = Config.load(out_dir / "cfg.json")
    _, scene = make_scene_data(n_train=16, n_test=4, width=128, height=128, device=DEVICE)
    state, it = rr.load_rig(out_dir, cfg, scene, DEVICE)
    if it != n:
        raise RuntimeError(f"[multihost] the --dp 2 rig reloaded at iteration {it}, not {n}")
    tail = [l for l in out.splitlines() if l.strip()][-2:]
    print(f"[multihost] torch_run_pipeline.py --synthetic --dp 2 (two gloo ranks on the card, MH_CLI_SCHEDULE): exactly "
          f"the files of a one-process run, from rank 0; each line printed once; rig/ reloaded at iteration {it} "
          f"({int(state.gs.num_alive)} Gaussians, J = {state.skel.net.n_joints}); {tail}")
    lines = [l for l in sout.splitlines() if l.startswith("data=")]
    if src or len(lines) != 2:
        raise RuntimeError(f"[multihost] torch_scaling_bench.py exit {src}:\n{sout[-2000:]}\n{serr[-3000:]}")
    print(f"[multihost] torch_scaling_bench.py --ranks 2 --iters {MH_ITERS} (two ranks share one card over gloo, "
          f"beside the other twins: no time here is one of two cards): {' | '.join(lines)}")


def multihost_phase(cap, gs, skel):
    """[multihost]: two processes on the card join through init_distributed
    from torchrun's environment (gloo: two ranks on one card) and build
    make_host_mesh (2 x 1); each feeds MH_STEPS full-width dp stage-2 steps
    (the serving avatar and [tileshard]'s frames, it = 15001) through
    host_local_frames + global_batch, and again through the whole stack
    (shard_batch): the states bitwise equal both ways, and hashed equal on
    both ranks; the ranks save the state with the sharded pair, and this
    process loads it onto a fresh template, every leaf bitwise (bytes and
    seconds of both). The ranks' steps, the save and the load run alone on
    the card; then the twins run as processes of their own, side by side
    (_twin_commands, check_twins). Returns the phase's numbers."""
    import tempfile

    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ranks_part = _multihost_ranks(cap, gs, skel)
    with tempfile.TemporaryDirectory() as twin_dir:
        t_twins = time.perf_counter()
        runs = _finish(_start(_twin_commands(Path(twin_dir) / "run")), MH_TIMEOUT)
        twins_wall = time.perf_counter() - t_twins
        check_twins(runs, Path(twin_dir) / "run")
    print(f"[multihost] the twins, after the ranks, side by side: {twins_wall:.1f} s to the last one's end")
    return dict(ranks_part, twins_wall_s=twins_wall)


def _multihost_ranks(cap, gs, skel):
    """[multihost]'s two ranks (see multihost_phase) and the reload of
    their checkpoint here; returns its numbers."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from riggs_tpu_torch.io.checkpoint import load_checkpoint_sharded

    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_multihost_rank, args=(2, _free_port(), cap, out_dir), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + MH_TIMEOUT
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError(f"[multihost] the two ranks did not finish in {MH_TIMEOUT} s")
        wall = time.perf_counter() - t0
        r0, r1 = (torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False) for r in range(2))
        files = sorted(Path(out_dir, "mh").rglob("*.*"))
        disk = sum(p.stat().st_size for p in files)
        template = fresh_state(gs, skel, 0, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back, it = load_checkpoint_sharded(Path(out_dir) / "mh", template)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        loaded = _state_hash(back)
        del back, template
    print(f"[multihost] two ranks through init_distributed (torchrun's environment) on one card, {wall:.1f} s "
          f"(spawn, set-up and every case): mesh {r0['mesh'][0]}, backend {r0['mesh'][2]}, card {r0['mesh'][3]}")
    for r, res in enumerate((r0, r1)):
        if not res["finite"] or not res["global_is_shard"] or res["hash"] != res["shard_hash"] \
                or res["losses"] != res["shard_losses"] or res["mesh"][:3] != ({"data": 2, "tile": 1}, r, "gloo"):
            raise RuntimeError(f"[multihost] rank {r}: finite {res['finite']}, global_batch == shard_batch "
                               f"{res['global_is_shard']}, hashes {res['hash'][:12]} / {res['shard_hash'][:12]}, "
                               f"losses {res['losses']} / {res['shard_losses']}, mesh {res['mesh']}")
    if r0["hash"] != r1["hash"] or r0["picks"] != r1["picks"]:
        raise RuntimeError("[multihost] the ranks' states or frame picks differ")
    if it != MH_STEPS or loaded != r0["hash"]:
        raise RuntimeError(f"[multihost] the sharded checkpoint loaded at iteration {it}, hash {loaded[:12]} vs "
                           f"{r0['hash'][:12]}")
    print(f"[multihost] make_dp_stage2_step 2 x 1, {MH_STEPS} steps at it={TRAIN_ITS[-1]} fed by host_local_frames + "
          f"global_batch (picks {r0['picks']}): losses {', '.join(f'{v:.6f}' for v in r0['losses'])}, the same bits "
          f"as the steps fed by shard_batch of the whole stack, states bitwise equal both ways and on both ranks; "
          f"{r0['ms']:.2f} / {r0['shard_ms']:.2f} ms a step after the first (global_batch / shard_batch; the ranks "
          f"alone on the card)")
    print(f"[multihost] the sharded checkpoint: {len(files)} files, {disk} bytes (rank 0 wrote {r0['save_bytes']}, "
          f"rank 1 {r1['save_bytes']}); saved in {r0['save_s']:.3f} / {r1['save_s']:.3f} s (ranks 0 / 1); loaded "
          f"onto a fresh template in one process in {load_s:.3f} s, every leaf bitwise")
    return dict(ms=r0["ms"], shard_ms=r0["shard_ms"], save_s=max(r0["save_s"], r1["save_s"]), load_s=load_s,
                bytes=disk, ranks_wall_s=wall)


# ---------------------------------------------------------------------------
# [anim]: the stage-1 animation path
# ---------------------------------------------------------------------------

ANIM_T = 0.4  # the animated frame's time
ANIM_DRAG = 24  # nodes dragged
ANIM_DRAG_SCALE = 0.05  # their seeded displacement's scale
ANIM_KEY_POSES = (2, 6)  # random_motion_poses' two key poses
ANIM_FRAMES = 4  # interpolate_key_poses' frames a segment
GEO_D2_ULPS = 16  # the KNN's squared distances card vs CPU: this many ulps (2^-24) of the largest |x|^2


class _CovCapture:
    """Record the covariances a module's callers hand to fit_rotations
    (node_warp.p2dR's by default; edit/arap_deform.py's deform_arap)."""

    def __init__(self, module=None):
        from riggs_tpu_torch.models import node_warp

        self.nw, self.covs = module or node_warp, []

    def __enter__(self):
        self.orig = self.nw.fit_rotations

        def rec(cov):
            self.covs.append(cov.detach().clone())
            return self.orig(cov)

        self.nw.fit_rotations = rec
        return self

    def __exit__(self, *exc):
        self.nw.fit_rotations = self.orig


def check_cov_fits(covs, tag):
    """The covariance entry (fit_rotations) against fit_rotations_plain on
    recorded covariances, as check_rotfit holds it on a step's: finite, a
    second launch bitwise equal, max |d R| <= ROTFIT_TOL on the well-posed
    fits (conditioning from a float64 SVD), |det R - 1| <= ROTFIT_TOL on
    every fit, the ill-posed counted; on the last, by CUDA events, a
    call's ms, its device ms a launch back to back, the plain version's,
    torch.linalg.svd's, and the bound."""
    import torch

    from riggs_tpu_torch.ops import geometry as GEO

    err = det_err = 0.0
    n_fits = ill = 0
    for cov in covs:
        C, C2, P = GEO.fit_rotations(cov), GEO.fit_rotations(cov), GEO.fit_rotations_plain(cov)
        if not bool(torch.isfinite(C).all()) or not _same_bits(C, C2):
            raise RuntimeError(f"{tag} fit_rotations {tuple(cov.shape)}: non-finite, or two launches differ")
        well = _conditioning(cov.double()) >= ILL_POSED
        if bool(well.any()):
            err = max(err, float((C - P).abs().amax(dim=(-2, -1))[well].max()))
        det_err = max(det_err, float((torch.linalg.det(C.double()) - 1.0).abs().max()))
        n_fits += cov.shape[0]
        ill += int((~well).sum())
    if not (err <= ROTFIT_TOL and det_err <= ROTFIT_TOL):
        raise RuntimeError(f"{tag} fit_rotations: max |d R| {err:.3e} on well-posed fits, max |det R - 1| "
                           f"{det_err:.3e}; the limit is {ROTFIT_TOL}")
    cov = covs[-1]
    fit = lambda: GEO.fit_rotations(cov)
    fit()
    torch.cuda.synchronize()
    p1 = _event_ms(lambda: GEO.fit_rotations_plain(cov), 5)
    k1, k2 = _event_ms(fit, 50), _event_ms(fit, 50)
    p2 = _event_ms(lambda: GEO.fit_rotations_plain(cov), 5)
    library = _event_ms(lambda: torch.linalg.svd(cov), 5)
    dev_ms = _held_ms(fit)
    bound = _bound(cov.shape[0] * ROTFIT_COV_BYTES, 0, 0)
    print(f"{tag} fit_rotations: {len(covs)} call(s), {n_fits} fits, {ill} ill-posed (conditioning < {ILL_POSED}); "
          f"max |d R| {err:.3e} on the well-posed, max |det R - 1| {det_err:.3e}; a second launch bitwise equal; "
          f"on {cov.shape[0]} covariances: a call {k1:.4f}/{k2:.4f} ms, device {dev_ms:.5f} ms a launch back to "
          f"back, plain {p1:.3f}/{p2:.3f} ms, torch.linalg.svd {library:.3f} ms; bound {bound['bound_ms']:.2e} ms "
          f"by {bound['bound_by']}")
    return dict(err=err, det_err=det_err, fits=n_fits, ill_posed=ill, ms=(k1 + k2) / 2, device_ms=dev_ms,
                plain_ms=(p1 + p2) / 2, library_ms=library, batch=cov.shape[0], **bound)


def _path_hops(mat):
    """The largest hop count, off the diagonal, of the paths that the
    min-plus relaxations of the graph ``mat`` (N, N) keep, relaxed as
    min_plus_closure relaxes it (an edge is one hop)."""
    m, h = mat.clone(), mat.isfinite().to(mat.dtype)
    for i in range(m.shape[0]):
        cand = m[:, i, None] + m[None, i, :]
        better = cand < m
        m = m.where(~better, cand)
        h = h.where(~better, h[:, i, None] + h[None, i, :])
    return int(h.fill_diagonal_(0).max())


def _geodesic_limit(g_card, g_cpu, geo_cpu):
    """The bound on |geodesic_floyd card - CPU| off the diagonal, for two
    graphs with the same edges (N, N; both on the CPU): a shortest path of
    H hops in one graph is a path of the other whose length differs by at
    most H times the largest edge difference, and each of the two f32 sums
    of H edges rounds by at most H ulps (2^-24) of the largest finite
    distance, so |d| <= H (max |d edge| + 2^-23 max geo). H is the larger
    of the two graphs' largest hop counts. Returns (bound, H, max |d edge|)."""
    import torch

    off = g_cpu.isfinite() & ~torch.eye(g_cpu.shape[0], dtype=torch.bool)
    edge_err = float((g_card - g_cpu)[off].abs().max())
    hops = max(_path_hops(g.to(DEVICE)) for g in (g_card, g_cpu))  # exact: the same on any device
    far = float(geo_cpu[geo_cpu.isfinite()].max())
    return hops * (edge_err + 2.0 ** -23 * far), hops, edge_err


def anim_phase(blend, gs, skel, cam, bg, frame_train):
    """[anim]: from [stage1]'s initial state (stage1_setup: the avatar's
    100000 alive of 131072 slots, 512 nodes, 800x800), warp_forward_animated
    at t = ANIM_T with a seeded drag of ANIM_DRAG nodes, and the frame
    rendered with its d_xyz, d_rotation and d_rotation_bias, the launch
    counters zeroed just before and read just after: fit_rotations
    launched (p2dR's fit) and each launch held to fit_rotations_plain
    (check_cov_fits); geodesic_floyd on the card against the port on the
    CPU for the same posed nodes (no edge in one graph only; the shared
    squared edges within the KNN expansion's rounding, GEO_D2_ULPS, and the
    self distances within its square root; the min-plus closure of the
    same graph bitwise; the whole call's same inf pattern and its
    off-diagonal differences within _geodesic_limit); the frame
    finite; a second call bitwise equal; the animated frame's ms and
    geodesic_floyd's. Then interpolate_key_poses between two seeded poses
    of the 24-joint avatar drives render_rigged for ANIM_FRAMES frames, the
    first within PATH_TOL of the first key pose's own frame."""
    import torch

    from riggs_tpu_torch.eval.synthesis import random_motion_poses, render_rigged
    from riggs_tpu_torch.models import node_warp as NW
    from riggs_tpu_torch.ops import arap as A
    from riggs_tpu_torch.ops import geometry as GEO
    from riggs_tpu_torch.render.api import render, tier_kwargs
    from riggs_tpu_torch.skeleton.interpolation import interpolate_key_poses

    t0 = time.perf_counter()
    cfg, state0, _, _, _ = stage1_setup(gs, bg, frame_train)
    warp, g = state0.warp, state0.gs
    tiers = tier_kwargs((cfg.pipe.max_tiles_per_gaussian, cfg.pipe.mid_cap, cfg.pipe.mid_side))
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    bias = torch.zeros((warp.node_num, 3), device=DEVICE)
    drag = torch.randperm(warp.node_num, generator=gen, device=DEVICE)[:ANIM_DRAG]
    bias[drag] = ANIM_DRAG_SCALE * torch.randn((ANIM_DRAG, 3), generator=gen, device=DEVICE)
    t = torch.tensor(ANIM_T, device=DEVICE)

    def animated(window):
        with torch.no_grad():
            out = NW.warp_forward_animated(warp, g.xyz, t, g.feature, g.motion_mask, bias)
            img = render(cam, g, bg, d_xyz=out["d_xyz"], d_rotation=out["d_rotation"],
                         d_rotation_bias=out["d_rotation_bias"], active_sh_degree=g.max_sh_degree,
                         max_per_tile=window, **tiers)
        return out, img

    _, probe = animated(8192)
    window = int(-(-int(probe["tile_counts"].max()) // 128) * 128)
    torch.cuda.synchronize()
    print(f"[anim] set-up {time.perf_counter() - t0:.1f} s: [stage1]'s initial state ({int(g.num_alive)} of "
          f"{g.capacity} slots, {warp.node_num} nodes), {ANIM_DRAG} nodes dragged by N(0, {ANIM_DRAG_SCALE}^2), "
          f"t = {ANIM_T}; window {window}")

    # the main path, counters zeroed just before and read just after
    torch.cuda.synchronize()
    blend.reset_launches()
    GEO.reset_launches()
    with _CovCapture() as cap:
        out, img = animated(window)
        torch.cuda.synchronize()
    launches = {**{k: v for k, v in blend.launches.items() if v}, **dict(GEO.launches)}
    print(f"[anim] launch counters over warp_forward_animated + render: {launches}")
    if GEO.launches["fit_rotations"] < 1 or not blend.launches["blend_cm"]:
        raise RuntimeError(f"[anim] the path did not launch fit_rotations and blend_cm: {launches}")
    _check_frame(img, SIZE, "[anim] the animated frame")
    for k in ("d_xyz", "d_rotation_bias", "d_nodes"):
        if not bool(torch.isfinite(out[k]).all()):
            raise RuntimeError(f"[anim] warp_forward_animated's {k} is not finite")
    out2, img2 = animated(window)
    same = {k: _same_bits(out[k], out2[k]) for k in ("d_xyz", "d_rotation_bias")}
    same["render"] = _same_bits(img["render"], img2["render"])
    if not all(same.values()):
        raise RuntimeError(f"[anim] a second call differs: {same}")
    rot = check_cov_fits(cap.covs, "[anim]")
    del out2, img2

    # geodesic_floyd on the card against the port on the CPU, on the same posed
    # nodes: the same edges; the shared squared edges within the KNN expansion's
    # rounding (|x|^2 - 2 x.y + |y|^2: GEO_D2_ULPS ulps of the largest |x|^2;
    # the self edges are that rounding's square root); the min-plus closure of
    # one graph bitwise; the whole call within _geodesic_limit
    with torch.no_grad():
        cur = (warp.nodes[:, :3] + NW.node_deform(warp, t)["d_xyz"]).detach()
    geo, geo_cpu = A.geodesic_floyd(cur, K=3).cpu(), A.geodesic_floyd(cur.cpu(), K=3)
    graph, graph_cpu = A.knn_graph(cur, K=3), A.knn_graph(cur.cpu(), K=3)
    closure_same = torch.equal(A.min_plus_closure(graph).cpu(), A.min_plus_closure(graph.cpu()))
    g_card = graph.cpu()
    fin = torch.isfinite(graph_cpu) & torch.isfinite(g_card)
    edges_differ = int((torch.isfinite(graph_cpu) != torch.isfinite(g_card)).sum())
    same_pattern = torch.equal(torch.isfinite(geo), torch.isfinite(geo_cpu))
    d2_bound = GEO_D2_ULPS * 2.0 ** -24 * float((cur * cur).sum(-1).max())
    d2_err = float((g_card[fin] ** 2 - graph_cpu[fin] ** 2).abs().max())
    off = torch.isfinite(geo_cpu) & ~torch.eye(cur.shape[0], dtype=torch.bool)
    geo_err = float((geo - geo_cpu)[off].abs().max())
    self_max = float(torch.diagonal(geo_cpu).abs().max().clamp_min(torch.diagonal(geo).abs().max()))
    geo_bitwise = torch.equal(geo, geo_cpu)
    geo_limit, hops, edge_err = _geodesic_limit(g_card, graph_cpu, geo_cpu)
    if not (edges_differ == 0 and d2_err <= d2_bound and self_max <= d2_bound ** 0.5 and closure_same
            and same_pattern and geo_err <= geo_limit):
        raise RuntimeError(f"[anim] geodesic_floyd card vs CPU: {edges_differ} edges in one graph only, max |d edge^2| "
                           f"{d2_err:.3e} (bound {d2_bound:.3e}), self distances {self_max:.3e} (bound "
                           f"{d2_bound ** 0.5:.3e}), closure of the same graph bitwise {closure_same}, the same inf "
                           f"pattern {same_pattern}, max |d| {geo_err:.3e} (bound {geo_limit:.3e})")
    geo_ms = _event_ms(lambda: A.geodesic_floyd(cur, K=3), 3)
    closure_ms = _event_ms(lambda: A.min_plus_closure(graph), 3)
    frame_ms = _host_ms(lambda: animated(window), 5)
    warp_ms = _host_ms(lambda: NW.warp_forward(warp, g.xyz, t, g.feature, g.motion_mask), 5)
    print(f"[anim] geodesic_floyd on the {cur.shape[0]} posed nodes (K + 1 = 4): the min-plus closure of the same "
          f"graph bitwise equal on the card and the CPU; the graphs: {edges_differ} edges in one only, max |d edge^2| "
          f"{d2_err:.2e} on the shared (the expansion's rounding bound {d2_bound:.2e}), max |d edge| {edge_err:.2e}; "
          f"the whole call card vs CPU: the same inf pattern, bitwise {geo_bitwise}, max |d| {geo_err:.2e} off the "
          f"diagonal (bound {geo_limit:.2e}: shortest paths of up to {hops} hops), the self distances (sqrt of the "
          f"rounding) up to {self_max:.2e} (bound {d2_bound ** 0.5:.2e}); "
          f"{int((~torch.isfinite(geo_cpu)).sum())} inf entries; {geo_ms:.3f} ms a call "
          f"({closure_ms:.3f} ms the {cur.shape[0]} relaxations) by CUDA events")
    print(f"[anim] the animated frame (warp_forward_animated + render, {SIZE}x{SIZE}): {frame_ms:.2f} ms by the host "
          f"clock around synchronized calls (warp_forward alone {warp_ms:.2f} ms); finite, no overflow; a second "
          f"call bitwise equal {same}")

    # key poses: interpolate_key_poses drives render_rigged
    poses = random_motion_poses(len(PARENTS), seed=0, pose_num=8)
    rots = torch.tensor(np.stack([poses[i]["local_rotation"] for i in ANIM_KEY_POSES]), device=DEVICE)
    trans = torch.tensor(np.stack([poses[i]["global_trans"] for i in ANIM_KEY_POSES]), device=DEVICE)
    qs, ts = interpolate_key_poses(rots, trans, frames_per_segment=ANIM_FRAMES)
    frames = [render_rigged(gs, skel, cam, pose={"local_rotation": q, "global_trans": tr}, bg=bg, max_per_tile=8192)
              for q, tr in zip(qs, ts)]
    for i, f in enumerate(frames):
        _check_frame(f, SIZE, f"[anim] key-pose frame {i}")
    key = render_rigged(gs, skel, cam, pose={"local_rotation": rots[0], "global_trans": trans[0]}, bg=bg,
                        max_per_tile=8192)
    first = float((frames[0]["render"] - key["render"]).abs().max())
    if not first <= PATH_TOL["image"]:
        raise RuntimeError(f"[anim] the first interpolated frame vs key pose {ANIM_KEY_POSES[0]}: {first:.3e}")
    step = float(max((a["render"] - b["render"]).abs().max() for a, b in zip(frames, frames[1:])))
    print(f"[anim] interpolate_key_poses between random-motion poses {ANIM_KEY_POSES} ({len(PARENTS)} joints): "
          f"{len(frames)} render_rigged frames, finite, no overflow; the first vs the key pose's own frame "
          f"{first:.2e}; max |d| between neighbours {step:.3f}")
    return dict(launches=launches, rot=rot, frame_ms=frame_ms, warp_ms=warp_ms, geo_ms=geo_ms,
                closure_ms=closure_ms, geo_err=geo_err, geo_limit=geo_limit, d2_err=d2_err, geo_bitwise=geo_bitwise,
                same=same)


# [edit]: the ARAP editor on the serving avatar, as the viewer drives it
EDIT_CTRL = 256  # EditSession's FPS controls (the viewer's /edit/init default)
EDIT_VIEW = (0.0, 0.3, 3.0)  # the viewer's default orbit: azimuth, elevation, radius
EDIT_DRAG_PX = 24.0  # the seeded drag's largest screen-space step, pixels
# deform_arap on the card against the port on the CPU for the same deformer
# and handles: the positions within this share of the controls' extent (a
# dense f32 LU solve chained with three rotation fits; the fits differ by
# ~2e-6 card vs CPU, PERF.md), the handles on their targets within 1e-6 of it
EDIT_TOL = 1e-4
HANDLE_TOL = 1e-6
FPS_RENDERS = 200  # scripts/torch_test_speed.py's timed renders in [viewer]


VIEW_FWD = ("blend_cm_fwd", "blend_permuted_gm_fwd")  # the forward entries a viewer frame can launch


def _hold_view_frame(blend, capture, tag):
    """A viewer frame's forward launches (``_Capture(blend, VIEW_FWD)``:
    the window of 512, and the tile ladder the viewer fitted to the frame)
    held to their plain versions at the frame's own shapes (check_kernels).
    The ladder's launches must be there: the frames held here overflow 512."""
    calls = {name: capture.calls[f"{name}_fwd"] for name in ("blend_cm", "blend_permuted_gm")}
    if not calls["blend_permuted_gm"]:
        raise RuntimeError(f"{tag}: no blend_permuted_gm launch (the viewer's ladder)")
    return check_kernels(blend, {k: v for k, v in calls.items() if v}, tag=tag)


def edit_phase(blend, gs, skel):
    """[edit]: the serving avatar (100 000 alive of 131 072 slots, 800x800)
    in a ViewerServer; EditSession with EDIT_CTRL FPS controls; one control,
    seeded among those in view, picked at its projected pixel in the
    viewer's default orbit (after the control farthest from it on screen,
    picked as a handle that stays) and dragged by a seeded delta, the edited frame
    rendered, and optimize_weights run once on the drag, the counters zeroed
    just before and read just after: fit_rotations launched 3 times (one a
    solve iteration) and estimate_rotations at least once (the energy's
    fit), each launch held to its plain version (check_cov_fits,
    check_rotfit), blend_cm launched, the edited frame's forward launches
    held to their plain versions at its own shapes (_hold_view_frame), its
    counters 0. deform_arap on the card against the
    port on the CPU for the same deformer and handles (EDIT_TOL of the
    extent), the handles on their targets, the frame finite, the new
    weights finite and moved; a second drag from a cleared session bitwise
    equal. Times: a drag (pick, solve, blend of d_xyz) and the edited frame,
    host clock around synchronized calls."""
    import dataclasses

    import torch

    from riggs_tpu_torch.camera.camera import project_nodes_2d
    from riggs_tpu_torch.edit import arap_deform as AD
    from riggs_tpu_torch.edit.session import EditSession
    from riggs_tpu_torch.ops import geometry as GEO
    from riggs_tpu_torch.viz.web_viewer import ViewerServer

    t0 = time.perf_counter()
    viewer = ViewerServer(gs, skel=skel, width=SIZE, height=SIZE, device=DEVICE)
    cam = viewer._camera(*EDIT_VIEW)
    sess = viewer.edit = EditSession(gs.xyz, n_ctrl=EDIT_CTRL, device=DEVICE)
    rc = project_nodes_2d(cam, sess.ctrl_rest).cpu().numpy()
    inside = np.flatnonzero((rc.min(1) > 0) & (rc.max(1) < SIZE))
    rng = np.random.default_rng(15)
    target = int(rng.choice(inside))
    # a second handle that stays put: the control in view farthest on screen
    # (one handle alone drags the whole graph rigidly, at zero ARAP energy)
    anchor = int(inside[np.argmax(np.hypot(*(rc[inside] - rc[target]).T))])
    delta = rng.uniform(-EDIT_DRAG_PX, EDIT_DRAG_PX, size=2)
    extent = float(torch.linalg.norm(sess.ctrl_rest.amax(0) - sess.ctrl_rest.amin(0)))
    torch.cuda.synchronize()
    print(f"[edit] set-up {time.perf_counter() - t0:.1f} s: EditSession over the {gs.capacity} slots, "
          f"{sess.ctrl_rest.shape[0]} FPS controls ({inside.size} in view), K = {sess.deformer.nn_idx.shape[1]}; "
          f"control {anchor} pinned, control {target} dragged by ({delta[0]:.2f}, {delta[1]:.2f}) px")

    def drag():
        picked = [sess.pick(cam, float(rc[i, 1]), float(rc[i, 0])) for i in (anchor, target)]
        sess.drag(cam, float(delta[0]), float(delta[1]))
        return picked

    # the main path, counters zeroed just before and read just after
    torch.cuda.synchronize()
    blend.reset_launches()
    GEO.reset_launches()
    with _CovCapture(AD) as covs, _RotCapture() as rots:
        picked = drag()
        with _Capture(blend, VIEW_FWD) as frame_calls:
            frame = viewer.render_frame(*EDIT_VIEW, 0.0, "edited")
        prev, cur = sess.ctrl_rest, sess.ctrl_cur
        tuned = AD.optimize_weights(sess.deformer, prev, cur)
        torch.cuda.synchronize()
    launches = {**{k: v for k, v in blend.launches.items() if v}, **dict(GEO.launches)}
    print(f"[edit] launch counters over two picks, a drag, the edited frame and optimize_weights: {launches}")
    if picked != [anchor, target] or launches["fit_rotations"] != 3 or launches["estimate_rotations"] < 1 \
            or not launches.get("blend_cm"):
        raise RuntimeError(f"[edit] picked {picked} (want {[anchor, target]}); launches {launches}: want "
                           "fit_rotations 3 a "
                           "solve, estimate_rotations and blend_cm")
    _check_frame(frame, SIZE, "[edit] the edited frame")
    if viewer.frames.overflow != {"overflow_tiles": 0, "overflow_rect": 0}:
        raise RuntimeError(f"[edit] the edited frame overflowed its windows: {viewer.frames.overflow}")
    frame_held = _hold_view_frame(blend, frame_calls, "[edit] the edited frame")
    idx = torch.as_tensor(np.asarray(sess.kps.get_kpt_idx(), np.int64), device=DEVICE)
    want = torch.as_tensor(np.asarray(sess.kps.get_kpt(), np.float32), device=DEVICE)
    handle_err = float((sess.ctrl_cur[idx] - want).abs().max())
    moved = float((sess.ctrl_cur - sess.ctrl_rest).abs().max())
    e0 = float(AD.arap_energy(sess.deformer, prev, cur))
    e1 = float(AD.arap_energy(tuned, prev, cur))
    w_moved = float((tuned.weight - sess.deformer.weight).abs().max())
    if not (handle_err <= HANDLE_TOL * extent and bool(torch.isfinite(tuned.weight).all()) and w_moved > 0):
        raise RuntimeError(f"[edit] handles off their targets by {handle_err:.3e} (extent {extent:.3f}), or the tuned "
                           f"weights not finite or unmoved ({w_moved:.3e})")
    rot_cov = check_cov_fits(covs.covs, "[edit]")
    fits = [(s, t, type(c)(*(x.detach() for x in c))) for s, t, c in rots.fits]
    rot_est = check_rotfit(fits, "[edit]")

    # deform_arap card vs the port on the CPU, the same deformer and handles
    cpu = dataclasses.replace(sess.deformer, **{f.name: getattr(sess.deformer, f.name).cpu()
                                                 for f in dataclasses.fields(sess.deformer)})
    p_card, q_card = AD.deform_arap(sess.deformer, idx, want)
    p_cpu, q_cpu = AD.deform_arap(cpu, idx.cpu(), want.cpu())
    pos_err = float((p_card.cpu() - p_cpu).abs().max())
    q_err = float(torch.minimum((q_card.cpu() - q_cpu).abs().amax(-1), (q_card.cpu() + q_cpu).abs().amax(-1)).max())
    if not pos_err <= EDIT_TOL * extent:
        raise RuntimeError(f"[edit] deform_arap card vs CPU: max |d p| {pos_err:.3e}, the limit {EDIT_TOL} x extent "
                           f"{extent:.3f}")

    # a second drag from a cleared session: bitwise the first
    first = (sess.ctrl_cur.clone(), sess.d_xyz.clone())
    sess.clear()
    drag()
    same = _same_bits(first[0], sess.ctrl_cur) and _same_bits(first[1], sess.d_xyz)
    if not same:
        raise RuntimeError("[edit] a second drag from a cleared session differs from the first")
    drag_ms = _host_ms(lambda: (sess.clear(), drag()), 5)
    solve_ms = _host_ms(sess.solve, 5)
    frame_ms = _host_ms(lambda: viewer.render_frame(*EDIT_VIEW, 0.0, "edited"), 5)
    print(f"[edit] the controls moved up to {moved:.4f} (extent {extent:.3f}); handles on their targets within "
          f"{handle_err:.2e}; deform_arap card vs CPU: max |d p| {pos_err:.3e} ({pos_err / extent:.2e} of the extent, "
          f"limit {EDIT_TOL:.0e}), quaternions up to sign {q_err:.3e}; optimize_weights: ARAP energy {e0:.6e} -> "
          f"{e1:.6e}, weights moved up to {w_moved:.3e}; a second drag from a cleared session bitwise equal")
    print(f"[edit] a drag (two picks, 4 solves, 3 rotation fits, the blend of d_xyz) {drag_ms:.2f} ms, the solve alone "
          f"{solve_ms:.2f} ms, the edited frame {frame_ms:.2f} ms ({SIZE}x{SIZE}, the viewer's windows, counters 0): "
          f"a drag and its frame "
          f"{drag_ms + frame_ms:.2f} ms, host clock around synchronized calls")
    return dict(launches=launches, cov=rot_cov, est=rot_est, drag_ms=drag_ms, solve_ms=solve_ms, frame_ms=frame_ms,
                pos_err=pos_err, q_err=q_err, handle_err=handle_err, held=frame_held)


def _http_get(port, path, timeout=120, headers=None):
    """(status, body) of a GET on localhost; the reply's headers into the
    dict ``headers`` where one is given."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            if headers is not None:
                headers.update(r.headers)
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _overflow_headers(what, headers):
    """A /render reply's overflow counters, which must be 0 (C8)."""
    got = (headers.get("X-Overflow-Tiles"), headers.get("X-Overflow-Rect"))
    if got != ("0", "0"):
        raise RuntimeError(f"[viewer] {what}: overflow headers (tiles, rect) {got}, want 0")


def _png(body, what):
    import io

    from PIL import Image

    if body[:4] != b"\x89PNG":
        raise RuntimeError(f"{what}: not a PNG")
    return np.asarray(Image.open(io.BytesIO(body)))


def _to_view_matrix(w2c):
    """The SIBR client's form of a camera: w2c^T with the Y/Z columns negated."""
    m = np.asarray(w2c, np.float32).T.copy()
    m[:, 1:3] = -m[:, 1:3]
    return m


def write_rig(root, gs, skel):
    """The serving avatar as the pipeline writes a rig: cfg.json,
    skeleton_tree.npz, rig/ (its checkpoint at iteration 1 and PLY)."""
    import torch

    from riggs_tpu_torch.io.checkpoint import save_checkpoint, save_skeleton_tree
    from riggs_tpu_torch.models import gaussians as G
    from riggs_tpu_torch.train import optim as O
    from riggs_tpu_torch.train.config import Config
    from riggs_tpu_torch.train.stage2 import Stage2State

    cfg = Config()
    cfg.model.capacity, cfg.model.sh_degree, cfg.model.gs_with_motion_mask = CAPACITY, SH_DEGREE, True
    cfg.model.use_skinning_weight_mlp = cfg.model.use_template_offsets = True
    cfg.opt.skeleton_weight_knn = -1
    state = Stage2State(gs=gs, skel=skel, opt_gs=O.adam_init(gs.params_dict()), opt_skel=O.adam_init(skel.params_dict()),
                        stats_gs=G.init_densify_stats(gs.capacity, device=DEVICE),
                        proj_loss=torch.ones(1, device=DEVICE), it=torch.zeros((), dtype=torch.int32, device=DEVICE))
    cfg.save(root / "cfg.json")
    save_skeleton_tree(root, skel.joints.cpu().numpy(), np.array(PARENTS), np.arange(len(PARENTS)), 0)
    save_checkpoint(root / "rig", 1, state, gs=gs, cfg=cfg)


def viewer_phase(blend, gs, skel, slice_ms):
    """[viewer]: ViewerServer on the serving avatar (800x800) on an
    ephemeral localhost port, the counters zeroed just before its requests
    and read just after: /, /render in rgb, skinning and motion mode and with
    a joint edit, /edit/init, /edit/pick at a control's pixel, /edit/drag and
    an edited render, /pose/save twice, /pose/play and a sequence render:
    every reply 200, every PNG decoded, every /render reply's overflow
    headers 0 (C8: the reference's window of 512 truncates the avatar, and
    the viewer renders such a frame again on its tile ladder), the rgb PNG
    equal to render_frame's frame quantized as the server quantizes it,
    blend_cm (the first frame at 512) and blend_permuted_gm (its ladder)
    launched. The viewer frame against a plain window that holds it
    (PATH_TOL), its ladder's launches held to their plain versions at the
    frame's own shapes (_hold_view_frame), the counters at 512 beside it;
    the viewer frame's ms (render_frame, and a /render round trip) and a
    render at 512 (the truncated frame the reference serves). Then a
    SibrServer polled with a SibrClient in a thread, rendering through a
    FrameHolder at 512 as the pipeline twin's endpoint renders: the reply's
    bytes equal to encode_image of the same render, its counters 0. Then scripts/torch_viewer.py as a
    process of its own on a rig directory written from the avatar, polled
    until it answers, its /render (the default 512x512 frame) equal to this
    process's, then stopped;
    then scripts/torch_test_speed.py --model_path on that directory with
    --renders 200 (its plain window grown from the first frame), and with
    --ladder: its FPS line beside [slice]'s serving frame, the timed frames'
    overflow 0."""
    import tempfile
    import threading

    import torch

    from riggs_tpu_torch.camera.camera import project_nodes_2d
    from riggs_tpu_torch.models import skeleton_warp as SW
    from riggs_tpu_torch.render.api import render
    from riggs_tpu_torch.render.ladder import ladder_rows
    from riggs_tpu_torch.viz.sibr import SibrClient, SibrServer, encode_image, quantize
    from riggs_tpu_torch.viz.web_viewer import FrameHolder, ViewerServer

    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        v = ViewerServer(gs, skel=skel, width=SIZE, height=SIZE, device=DEVICE, pose_lib_path=tmp / "poses.json")
        v.serve(port=0, blocking=False)
        port = v.httpd.server_address[1]
        replies = []

        def get(path):
            headers = {}
            status, body = _http_get(port, path, headers=headers)
            replies.append((path, status))
            if status != 200:
                raise RuntimeError(f"[viewer] GET {path}: {status} {body[:2000]!r}")
            if path.startswith("/render"):
                _overflow_headers(f"GET {path}", headers)
            return body

        t0 = time.perf_counter()
        torch.cuda.synchronize()
        blend.reset_launches()
        try:
            page = get("/")
            pngs = {q: _png(get(f"/render?t=0.3&{q}"), q)
                    for q in ("mode=rgb", "mode=skinning", "mode=motion", "mode=rgb&joint=4&angle=30")}
            n_ctrl = json.loads(get(f"/edit/init?n={EDIT_CTRL}"))["n_ctrl"]
            rc = project_nodes_2d(v._camera(*EDIT_VIEW), v.edit.ctrl_rest).cpu().numpy()
            i = int(np.flatnonzero((rc.min(1) > 0) & (rc.max(1) < SIZE))[0])
            picked = json.loads(get(f"/edit/pick?x={rc[i, 1]}&y={rc[i, 0]}"))["picked"]
            get("/edit/drag?dx=9&dy=-5")
            pngs["mode=edited"] = _png(get("/render?mode=edited"), "edited")
            get("/pose/save?name=a&t=0.2")
            get("/pose/save?name=b&t=0.8&joint=4&angle=30")
            frames = json.loads(get("/pose/play?names=a,b&frames=4"))["frames"]
            pngs["seq=2"] = _png(get("/render?seq=2"), "seq")
            torch.cuda.synchronize()
            launches = {k: n for k, n in blend.launches.items() if n}
            wall = time.perf_counter() - t0
            print(f"[viewer] {len(replies)} requests in {wall:.1f} s, every reply 200: "
                  f"{[p.split('?')[0] for p, _ in replies]}; launch counters over them: {launches}")
            if b"canvas" not in page or picked != i or n_ctrl != EDIT_CTRL or frames != 4 \
                    or not launches.get("blend_cm") or not launches.get("blend_permuted_gm"):
                raise RuntimeError(f"[viewer] page {b'canvas' in page}, picked {picked} (want {i}), {n_ctrl} controls, "
                                   f"{frames} frames, launches {launches}")
            for q, img in pngs.items():
                if img.shape != (SIZE, SIZE, 3):
                    raise RuntimeError(f"[viewer] /render {q}: a {img.shape} PNG")
            want = quantize(v.render_frame(*EDIT_VIEW, 0.3))
            if not np.array_equal(pngs["mode=rgb"], want):
                raise RuntimeError("[viewer] the rgb PNG is not render_frame's frame quantized")
            frame_ms = _host_ms(lambda: v.render_frame(*EDIT_VIEW, 0.5), 10)
            t1 = time.perf_counter()
            for k in range(5):
                _png(get(f"/render?t={k / 5}"), "timed")
            http_ms = (time.perf_counter() - t1) / 5 * 1e3
        finally:
            v.shutdown()
        # the frame as render_frame makes it: at the reference's window of 512
        # (its counters), and at a plain window that holds it
        with torch.no_grad():
            pose = SW.pose_at(skel, 0.3)
            d = SW.deform_by_pose(skel, gs.xyz, pose["local_rotation"], pose["global_trans"], gs.motion_mask)
            kw = dict(d_xyz=d["d_xyz"], d_rotation=d["d_rotation"], d_scaling=torch.zeros_like(d["d_scaling"]),
                      active_sh_degree=gs.max_sh_degree)
            cam_v, bg_v = v._camera(*EDIT_VIEW), torch.zeros(3, device=DEVICE)
            out = render(cam_v, gs, bg_v, max_per_tile=512, **kw)
            overflow = {k: int(out[k]) for k in ("overflow_tiles", "overflow_rect", "max_count")}
            hold = max(int(-(-overflow["max_count"] // 128) * 128), 512)
            held = render(cam_v, gs, bg_v, max_per_tile=hold, **kw)
            with _Capture(blend, VIEW_FWD) as frame_calls:
                got = v.render_frame(*EDIT_VIEW, 0.3)
        err = float((got - held["render"]).abs().max())
        if int(held["overflow"]) or v.frames.overflow != {"overflow_tiles": 0, "overflow_rect": 0} \
                or not err <= PATH_TOL["image"]:
            raise RuntimeError(f"[viewer] the viewer frame: counters {v.frames.overflow}, against the plain window "
                               f"{hold} (overflow {int(held['overflow'])}) max|d| {err:.3e}, limit {PATH_TOL['image']}")
        frame_held = _hold_view_frame(blend, frame_calls, "[viewer] the viewer frame")
        ladder = v.frames.ladder.ladder if v.frames.ladder is not None else None
        truncated_ms = _host_ms(lambda: render(cam_v, gs, bg_v, max_per_tile=512, **kw), 10)
        print(f"[viewer] the reference's window of 512 truncates the frame: overflow_tiles "
              f"{overflow['overflow_tiles']}, overflow_rect {overflow['overflow_rect']}, the largest tile count "
              f"{overflow['max_count']}; the viewer frame on its ladder {ladder} "
              f"({ladder_rows(ladder) if ladder else 0} rows) within {err:.3e} of the plain window {hold} "
              f"(limit {PATH_TOL['image']}), its counters 0")
        print(f"[viewer] a viewer frame (pose_at + deform_by_pose + render, {SIZE}x{SIZE}, on the windows that hold "
              f"it): {frame_ms:.2f} ms by the host clock around synchronized calls, a /render round trip (the frame, "
              f"its PNG, HTTP) {http_ms:.2f} ms; the truncated frame at 512 {truncated_ms:.2f} ms; [slice]'s serving "
              f"frame {slice_ms:.2f} ms at its fitted window")

        # SIBR: a client in a thread, the server polled as a training loop polls it
        server = SibrServer("127.0.0.1", 0, verify="chip_smoke", device=DEVICE)
        served, result = {}, {}
        sibr_frames = FrameHolder(512)  # the pipeline twin's SIBR render, at a window of 512

        def render_fn(cam, scaling_modifier):
            served.update(cam=cam, scale=scaling_modifier)
            with torch.no_grad():
                return sibr_frames(cam, gs, torch.zeros(3, device=DEVICE), scaling_modifier=scaling_modifier,
                                   active_sh_degree=gs.max_sh_degree)

        def client():
            c = SibrClient("127.0.0.1", server.port)
            result["img"], result["verify"] = c.request(SIZE, SIZE, _to_view_matrix(v._camera(*EDIT_VIEW).w2c.cpu()),
                                                        fovx=v.fov, fovy=v.fov, train=True)
            c.close()

        th = threading.Thread(target=client, daemon=True)
        th.start()
        for _ in range(600):
            server.poll(render_fn)
            if result:
                break
            time.sleep(0.05)
        th.join(timeout=30)
        server.close()
        sibr_same = bool(result) and result["img"].tobytes() == encode_image(render_fn(served["cam"], served["scale"]))
        if not sibr_same or result["verify"] != "chip_smoke" \
                or sibr_frames.overflow != {"overflow_tiles": 0, "overflow_rect": 0}:
            raise RuntimeError(f"[viewer] SIBR: reply {bool(result)}, bytes equal {sibr_same}, counters "
                               f"{sibr_frames.overflow}")
        print(f"[viewer] SIBR round trip: a {SIZE}x{SIZE} request answered with encode_image of the same render, "
              f"the verify string back; counters 0 on the ladder "
              f"{sibr_frames.ladder.ladder if sibr_frames.ladder is not None else None}")

        # the viewer twin as a process of its own, then the FPS twin
        t0 = time.perf_counter()
        write_rig(tmp, gs, skel)
        rig_s = time.perf_counter() - t0
        vport = _free_port()
        procs = _start([[sys.executable, str(root / "scripts" / "torch_viewer.py"), "--model_path", str(tmp), "--port",
                         str(vport), "--device", DEVICE]])
        try:
            t0 = time.perf_counter()
            while True:
                if procs[0].poll() is not None:
                    raise RuntimeError(f"[viewer] torch_viewer.py exited {procs[0].returncode}: "
                                       f"{procs[0].communicate()}")
                try:
                    status, _ = _http_get(vport, "/", timeout=5)
                    break
                except OSError:
                    if time.perf_counter() - t0 > 180:
                        raise RuntimeError("[viewer] torch_viewer.py never answered") from None
                    time.sleep(0.5)
            up = time.perf_counter() - t0
            twin_headers = {}
            status, body = _http_get(vport, "/render?t=0.3", headers=twin_headers)
            # the twin's viewer has the default 512 x 512 frame
            want_twin = quantize(ViewerServer(gs, skel=skel, device=DEVICE).render_frame(*EDIT_VIEW, 0.3))
            twin_same = status == 200 and np.array_equal(_png(body, "twin"), want_twin)
        finally:
            _kill(procs)
        _overflow_headers("torch_viewer.py's /render", twin_headers)
        if not twin_same:
            raise RuntimeError(f"[viewer] torch_viewer.py's /render: {status}, equal to this process's {twin_same}")
        print(f"[viewer] torch_viewer.py on the rig written from the avatar ({rig_s:.1f} s): answered after {up:.1f} s, "
              f"its /render (512x512, the default) equal to this process's frame; stopped")
        fps = {}
        for label, extra in (("plain windows", []), ("ladder", ["--ladder"])):
            cmd = [sys.executable, str(root / "scripts" / "torch_test_speed.py"), "--model_path", str(tmp), "--renders",
                   str(FPS_RENDERS), "--size", str(SIZE), "--device", DEVICE] + extra
            res = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
            out_lines = res.stdout.splitlines()
            line = [ln for ln in out_lines if " FPS (" in ln]
            counted = [json.loads(ln.split(":", 1)[1]) for ln in out_lines if ln.startswith("launches:")]
            first = [ln for ln in out_lines if ln.startswith("first frame")]
            window = [ln for ln in out_lines if ln.startswith("plain window")]
            timed = [ln for ln in out_lines if ln.startswith("timed frames: overflow")]
            if res.returncode != 0 or not line or not counted or timed != ["timed frames: overflow 0"]:
                raise RuntimeError(f"[viewer] torch_test_speed.py {extra} failed or truncated its timed frames:\n"
                                   f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
            fps[label] = dict(line=line[0], launches=counted[0], first=first[0] if first else "",
                              window=window[0] if window else "")
            m = re.search(r": ([0-9.]+)s = ([0-9.]+) FPS", line[0])
            fps[label]["ms"] = float(m.group(1)) / FPS_RENDERS * 1e3
            print(f"[viewer] torch_test_speed.py --renders {FPS_RENDERS} {' '.join(extra)}: {line[0]}; {fps[label]['first']}; "
                  f"{fps[label]['window'] or 'no window grown'}; {timed[0]}; launches {counted[0]} -> "
                  f"{fps[label]['ms']:.2f} ms a frame, beside [slice]'s serving frame {slice_ms:.2f} ms "
                  f"({1e3 / slice_ms:.1f} FPS)")
    return dict(launches=launches, frame_ms=frame_ms, http_ms=http_ms, overflow=overflow, fps=fps,
                truncated_ms=truncated_ms, ladder=ladder, err=err, held=frame_held)


# [bench]: scripts/torch_bench.py's three settings, and the kernels each runs
BENCH_RUNS = (("defaults", ()), ("--no-ladder", ("--no-ladder",)), ("--no-tiers", ("--no-tiers",)))
BENCH_KERNELS = {"defaults": ("blend_permuted_gm", "blend_permuted_gm_bwd"),
                 "--no-ladder": ("blend_cm", "blend_cm_bwd"),
                 "--no-tiers": ("blend_permuted_gm", "blend_permuted_gm_bwd")}
BENCH_TIMEOUT = 600


def bench_phase(blend):
    """[bench]: scripts/torch_bench.py as a process of its own at its
    defaults (bench.py's scene of 100 000 Gaussians at 800x800, the tiers,
    the ladder), with --no-ladder and with --no-tiers: each run's last line
    the reference's four-key JSON line (its overflow assert held, or it
    exits non-zero), the launches of its kernels over its timed steps
    (counted in that process, zeroed just before them) non-zero. Then each
    setting's gradient step in this process on the twin's own scene and
    windows: its caps truncate nothing, and its forward and backward
    kernels are held to their plain versions on the windows and cotangents
    the step gave them (check_kernels, check_bwd_kernels). Returns the
    runs (pixels/s, launches) and the held kernels by setting."""
    import torch

    from riggs_tpu_torch.render.tiles import rasterize_tiled
    from scripts import torch_bench as TB

    root = Path(__file__).resolve().parent
    runs = {}
    for label, flags in BENCH_RUNS:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(root / "scripts" / "torch_bench.py"), *flags], cwd=root,
                             capture_output=True, text=True, timeout=BENCH_TIMEOUT)
        wall = time.perf_counter() - t0
        lines = res.stdout.strip().splitlines()
        try:
            last = json.loads(lines[-1])
            launches = json.loads([ln for ln in lines if ln.startswith("launches:")][0].split(":", 1)[1])
        except (IndexError, json.JSONDecodeError):
            last, launches = None, {}
        if res.returncode != 0 or not isinstance(last, dict) \
                or set(last) != {"metric", "value", "unit", "vs_baseline"} \
                or not all(launches.get(k) for k in BENCH_KERNELS[label]):
            raise RuntimeError(f"[bench] torch_bench.py {label}: exit {res.returncode}, launches {launches}:\n"
                               f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        ladder = [ln for ln in lines if ln.startswith("ladder:")]
        runs[label] = dict(value=last["value"], vs_baseline=last["vs_baseline"], launches=launches, wall=wall,
                           ladder=ladder[0] if ladder else "no ladder")
        print(f"[bench] torch_bench.py {label} ({wall:.1f} s): {lines[-1]}; {runs[label]['ladder']}; launches over "
              f"its timed steps {launches}; {[ln for ln in lines if ln.startswith('card:')]}", flush=True)
    held = {}
    for label, flags in BENCH_RUNS:
        cam, inputs, bg, extra = TB.setup(TB.parse_args(list(flags)), torch.device(DEVICE))
        with torch.no_grad():
            chk = rasterize_tiled(cam, *inputs, bg, **extra)
        if int(chk["overflow"]):
            raise RuntimeError(f"[bench] {label}: the caps truncate {int(chk['overflow'])}")
        fwd, bwd = BENCH_KERNELS[label]
        with _Capture(blend, (f"{fwd}_fwd", bwd)) as c:
            TB.grad_step(cam, inputs, bg, extra)
        tag = f"[bench] {label}"
        held[label] = dict(fwd=check_kernels(blend, {fwd: c.calls[f"{fwd}_fwd"]}, tag=tag, per="step")[fwd],
                           bwd=check_bwd_kernels(blend, {bwd: c.calls[bwd]}, tag=tag)[bwd])
        del c, chk, inputs
    return dict(runs=runs, held=held)


def _pipeline_probes(gui_port, viewer_port, out):
    """Threads that reach the pipeline twin while it trains: a /render on
    its live viewer (retried until it answers 200) and one SIBR request
    (connecting until the server listens). Their outcomes land in ``out``."""
    import threading

    from riggs_tpu_torch.viz.sibr import SibrClient

    def viewer():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 600:
            try:
                status, body = _http_get(viewer_port, "/render?t=0.5&r=2.5", timeout=60)
                if status == 200:
                    out["viewer"] = _png(body, "[cli] live /render").shape
                    out["viewer_s"] = time.perf_counter() - t0
                    return
                out.setdefault("viewer_codes", []).append(status)
            except OSError:
                pass
            time.sleep(0.5)

    def sibr():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 600:
            try:
                c = SibrClient("127.0.0.1", gui_port)
            except OSError:
                time.sleep(0.2)
                continue
            view = np.eye(4, dtype=np.float32)
            view[3, 2] = -2.5  # the client's form of a camera 2.5 in front of the origin
            img, verify = c.request(96, 64, view, train=True)
            c.close()
            out["sibr"] = (img.shape, verify, float(img.mean()))
            return

    threads = [threading.Thread(target=f, daemon=True) for f in (viewer, sibr)]
    for t in threads:
        t.start()
    return threads


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    laps, last = {}, [time.perf_counter()]

    def lap(name):
        """The phases' wall times: seconds since the previous lap."""
        now = time.perf_counter()
        laps[name], last[0] = now - last[0], now
        print(f"[time] {name}: {laps[name]:.1f} s", flush=True)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from riggs_tpu_torch import cuda_build
    from riggs_tpu_torch.eval.synthesis import random_motion_poses, render_rigged
    from riggs_tpu_torch.ops import geometry as GEO
    from riggs_tpu_torch.render import blend
    from riggs_tpu_torch.render.ladder import ladder_rows, make_tile_ladder
    from riggs_tpu_torch.train.stage2 import _eval_image, eval_image

    # 1. device
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([cuda_build.nvcc(), "--version"], capture_output=True, text=True, check=True).stdout
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvcc: {[l for l in nvcc.splitlines() if 'release' in l][0].strip()}")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    cuda_build.build_all({blend.LIB_STEM: blend.CSRC, GEO.LIB_STEM: GEO.CSRC,
                          GEO.DEBUG_STEM: (GEO.CSRC, GEO.DEBUG_DEFINES)})
    blend.load_library()
    GEO.load_library()
    GEO.load_library(debug=True)
    print(f"[build] blend and rotation-fit kernels (sm_90a) and the rotation fit's sweep-counting debug build, "
          f"built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in (blend.build_log() + GEO.build_log()).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build]   {line.strip()}")

    # scene, window cap and ladder (set-up: probes over the frame times and
    # the random-motion pose run before the counted window)
    t0 = time.perf_counter()
    gs, skel, cam, bg = build_avatar(0, N_ALIVE, CAPACITY, SIZE, DEVICE)
    pose = {k: torch.as_tensor(v, device=DEVICE) for k, v in random_motion_poses(len(PARENTS), seed=0, pose_num=8)[4].items()}
    probe = [frame(gs, skel, cam, bg, t=t, max_per_tile=8192) for t in PROBE_TIMES]
    probe.append(frame(gs, skel, cam, bg, pose=pose, max_per_tile=8192))
    counts = np.stack([p["tile_counts"].cpu().numpy() for p in probe])
    cap = int(-(-counts.max() // 128) * 128)
    ladder = make_tile_ladder(counts)
    torch.cuda.synchronize()
    print(f"[scene] {int(gs.num_alive)} alive of {gs.capacity}, {len(PARENTS)} joints, {SIZE}x{SIZE}; "
          f"max tile count {int(counts.max())} -> window {cap}; ladder {ladder} "
          f"({ladder_rows(ladder)} rows vs {counts.shape[1] * cap}); {time.perf_counter() - t0:.1f} s")

    lap("device, build, scene")

    # 3. kernels against plain versions on the scene's real windows
    with _Capture(blend) as cap_plain:
        frame(gs, skel, cam, bg, t=0.3, max_per_tile=cap)
    with _Capture(blend) as cap_ladder:
        frame(gs, skel, cam, bg, t=0.3, max_per_tile=cap, tile_ladder=ladder)
    kres = check_kernels(blend, {"blend_cm": cap_plain.calls["blend_cm"],
                                 "blend_permuted_gm": cap_ladder.calls["blend_permuted_gm"]})
    check_oracle(DEVICE)
    edges_phase(blend, DEVICE)
    off_fwd, off_bwd = offset_edges_phase(blend, cap_plain.calls["blend_cm"])

    lap("kernels")

    # 4. the slice: the main path, launch counters zeroed just before
    torch.cuda.synchronize()
    blend.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plain_imgs = [eval_image(gs, skel, cam, t, bg) for t in FRAME_TIMES]
    for w in caught:
        if "capacity limits" in str(w.message):
            raise RuntimeError(f"eval_image truncated a frame: {w.message}")
    posed = render_rigged(gs, skel, cam, pose=pose, bg=bg, max_per_tile=cap)
    probe_counts = np.stack([render_rigged(gs, skel, cam, t=t, bg=bg, max_per_tile=cap)["tile_counts"].cpu().numpy()
                             for t in PROBE_TIMES] + [posed["tile_counts"].cpu().numpy()])
    ladder_fit = make_tile_ladder(probe_counts)
    ladder_imgs = []
    for t in FRAME_TIMES:
        img, of_t, of_r, _ = _eval_image(gs, skel, cam, t, bg, max_per_tile=cap, tile_ladder=ladder_fit)
        if int(of_t) or int(of_r):
            raise RuntimeError(f"ladder frame t={t}: overflow tiles {int(of_t)} rect {int(of_r)}")
        ladder_imgs.append(img)
    torch.cuda.synchronize()
    launches = dict(blend.launches)
    print(f"[slice] launch counters over the main path: {launches}")
    for name in ("blend_cm", "blend_permuted_gm"):
        if launches[name] <= 0:
            raise RuntimeError(f"the main path never launched {name}")
    if ladder_fit != ladder:
        raise RuntimeError(f"the refit ladder {ladder_fit} differs from the probe's {ladder}")
    for t, img in zip(FRAME_TIMES, plain_imgs + ladder_imgs):
        _check_frame(img, SIZE, f"frame t={t}")
    _check_frame(posed, SIZE, "random-motion pose")
    print(f"[slice] {len(FRAME_TIMES)} eval_image frames, 1 random-motion pose, "
          f"{len(PROBE_TIMES)} probe frames, {len(FRAME_TIMES)} laddered frames: finite, no overflow")

    # the forward kernels on other windows than [kernels]' own: the
    # random-motion pose's plain windows and a laddered frame at t = 0.9
    with _Capture(blend) as c_pose:
        render_rigged(gs, skel, cam, pose=pose, bg=bg, max_per_tile=cap)
    with _Capture(blend) as c_late:
        frame(gs, skel, cam, bg, t=0.9, max_per_tile=cap, tile_ladder=ladder)
    kern, plain = _fwd_entries(blend)
    with torch.no_grad():
        for name, what, calls in (("blend_cm", "the random-motion pose", c_pose.calls["blend_cm"]),
                                  ("blend_permuted_gm", "the ladder at t=0.9", c_late.calls["blend_permuted_gm"])):
            err, _ = _hold_fwd(name, calls, kern[name], plain[name])
            print(f"[slice] {name} on {what}: max|d| rgb/acc {err['rgb_acc']:.3e} depth {err['depth']:.3e}; "
                  "tentry bitwise equal, the same active pairs, a second launch bitwise equal")
    del c_pose, c_late

    # ladder vs plain windows, and kernel path vs plain-version path
    for t in (0.3, 0.9):
        a = frame(gs, skel, cam, bg, t=t, max_per_tile=cap)
        _check_frame(a, SIZE, f"plain t={t}")
        b = frame(gs, skel, cam, bg, t=t, max_per_tile=cap, tile_ladder=ladder)
        _check_frame(b, SIZE, f"ladder t={t}")
        _compare(a, b, f"ladder vs plain windows, t={t}")
    with _PlainBlend(blend):
        pa = frame(gs, skel, cam, bg, t=0.3, max_per_tile=cap)
        pb = frame(gs, skel, cam, bg, t=0.3, max_per_tile=cap, tile_ladder=ladder)
    _compare(frame(gs, skel, cam, bg, t=0.3, max_per_tile=cap), pa, "kernel vs plain-version path, plain windows")
    _compare(frame(gs, skel, cam, bg, t=0.3, max_per_tile=cap, tile_ladder=ladder), pb,
             "kernel vs plain-version path, ladder")

    # per-frame times of both paths (host clock around synchronized frames)
    frame_ms = {}
    for label, kw in (("plain windows", {}), ("ladder", {"tile_ladder": ladder})):
        _eval_image(gs, skel, cam, 0.5, bg, max_per_tile=cap, **kw)
        torch.cuda.synchronize()
        n = 20
        t0 = time.perf_counter()
        for i in range(n):
            _eval_image(gs, skel, cam, i / n, bg, max_per_tile=cap, **kw)
        torch.cuda.synchronize()
        frame_ms[label] = ms = (time.perf_counter() - t0) / n * 1e3
        print(f"[slice] {label}: {ms:.2f} ms per frame = {1e3 / ms:.1f} FPS (skeleton_forward + render, {SIZE}x{SIZE})")
    for label, kw in (("plain windows", {}), ("ladder", {"tile_ladder": ladder})):
        profile_frames(gs, skel, cam, bg, cap, kw, label, frame_ms[label])
        sync_audit(f"serving frame, skeleton_forward + render ({label})",
                   lambda kw=kw: frame(gs, skel, cam, bg, t=0.5, max_per_tile=cap, **kw))
    sync_audit("serving frame, eval_image (its two overflow counters read by design)",
               lambda: eval_image(gs, skel, cam, 0.5, bg, max_per_tile=cap),
               expected={_site(eval_image, "int(of_t)"): 2})

    lap("slice, sync")

    # 6. the training slice (its own counted run)
    train_launches, train_fwd, bres, frame_train = train_phase(blend, gs, skel, cam, bg, cap, ladder)

    lap("train")

    # 7. the aligned-runs render path (its own counted run)
    runs_launches, runs_fwd, runs_bwd = runs_phase(blend, gs, skel, cam, bg, cap, frame_train.image)

    lap("runs")

    # 8. the stage-1 phase-B step (its own counted run)
    stage1_launches, stage1_fwd, stage1_bwd, stage1_rot = stage1_phase(blend, gs, cam, bg, frame_train)

    lap("stage1")

    # 9-10. the [loop] scene; the stage-1 phase-A step (its own counted run)
    scene, loop_cap = build_loop_scene(gs, skel)
    pa_launches, pa_fwd, pa_bwd, pa_rot = stage1_phase_a(blend, scene)

    lap("loop scene, phase A")

    # 11. a short train_stage1 (its own counted run)
    loop_launches, loop_held, loop_rot, stage1_state, loop_b_ms = loop_phase(blend, scene, loop_cap)

    lap("loop")

    # 12. init_stage2 and a short train_stage2 from the loop's state (its own counted run)
    pipe_launches, pipe_held, pipe_state, pipe_info, pipe_cfg = pipeline_phase(blend, scene, loop_cap, stage1_state)

    lap("pipeline")

    # 13. save, reload and resume the rig; the test-set report (its own counted run)
    io_launches, io_held = io_phase(blend, scene, stage1_state, pipe_state, pipe_info, pipe_cfg)
    loop_warp = stage1_state.warp  # [hash]'s 512-node warp
    del stage1_state, pipe_state

    lap("io")

    # 14. train_stage1 with the optical-flow loss (its own counted run)
    flow_launches, flow_held, flow_rot = flow_phase(blend, scene, loop_cap, gs, skel, loop_b_ms)

    lap("flow")

    # 15. a ZJU-MoCap subject: the reader, the reference-point branch, the ZJU twin (its own counted run)
    zju_launches, zju_held, zju_rot = zju_phase(blend, gs, skel)

    lap("zju")

    # 16. the CLI twins of the pipeline and of the stage-2 resume as processes of their own
    cli_phase()

    lap("cli")

    # 17. the reference operating point's twin as a process of its own, then resumed
    refpoint_report, refpoint_launches = refpoint_phase()

    lap("refpoint")

    # 18. the compact and sort2 binners on the serving avatar (their own counted run)
    binners_launches, binners_res = binners_phase(blend, gs, skel, cam, bg, cap, frame_train.image)

    lap("binners")

    # 19-20. the static and MLP-deform trainers on the [loop] scene (their own counted runs)
    static_launches, static_held, static_times = static_phase(blend, scene, loop_cap)
    mlp_launches, mlp_held, mlp_times = mlpdeform_phase(blend, scene, loop_cap)

    lap("static, mlpdeform")

    # 21. the hash deform and the ARAP loss with rotations, card against CPU (its own counted run)
    hash_launches, hash_rot = hash_phase(gs, loop_warp)

    lap("hash")

    # 22. the tile-parallel path on two gloo ranks (its own counted run), then one NCCL rank
    ts_launches, ts_per_step, ts_res = tileshard_phase(cap)
    nccl_world_one(cap, ts_res.pop("dp21_leaves"))

    lap("tileshard")

    # 23. the frame-parallel stage-1 and static steps and train_stage1_dp on
    # two gloo ranks (their own counted runs), then one NCCL rank
    dp1 = dp1_phase()
    dp1_launches = dp1["launches"]
    dp1_world_one(dp1)
    lap("dp1")

    # 24. the multi-process launch, the sharded checkpoints and the twins of
    # scaling_bench.py and multihost_smoke.py, and the pipeline twin's --dp
    mh = multihost_phase(cap, gs, skel)

    lap("multihost")

    # 25. the stage-1 animation path (its own counted run): p2dR's rotation fit on the card
    anim = anim_phase(blend, gs, skel, cam, bg, frame_train)

    lap("anim")

    # 26. the ARAP editor on the serving avatar (its own counted run)
    edit = edit_phase(blend, gs, skel)

    lap("edit")

    # 27. the web viewer's endpoints (their own counted run), SIBR, the viewer and FPS twins
    viewer = viewer_phase(blend, gs, skel, frame_ms["plain windows"])

    lap("viewer")

    # 28. bench.py's twin as a process of its own at its three settings, its kernels held
    bench = bench_phase(blend)

    lap("bench")

    def bench_rows(name):
        """A blend row's launches in [bench]'s runs and its held steps there."""
        way = "bwd" if name.endswith("_bwd") else "fwd"
        pick = lambda r: {"max_abs_err": max(r["err"].values()) if isinstance(r["err"], dict) else r["err"],
                          "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"]}
        return {"launches_bench": {k: r["launches"].get(name, 0) for k, r in bench["runs"].items()},
                "held_bench": {k: pick(h[way]) for k, h in bench["held"].items() if name in BENCH_KERNELS[k]},
                "bench_pixels_per_s": {k: r["value"] for k, r in bench["runs"].items()}}

    def view_held(phase, name):
        """A viewer frame's launches of a kernel ([viewer]'s frame, [edit]'s
        edited frame) held to its plain version, or None where it made none."""
        r = phase["held"].get(name)
        return None if r is None else {"max_abs_err": max(r["err"].values()), "ms": r["ms"],
                                       "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                                       "shapes": [list(x) for x in r["shapes"]]}

    def held(name, results=loop_held):
        """A loop's held steps of a kernel: error, times and bound."""
        return {label: {"max_abs_err": max(r["err"].values()) if isinstance(r["err"], dict) else r["err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"]}
                for label, r in results[name].items()}

    def side_rows(name, way):
        """blend_cm's (way "fwd") or its backward's ("bwd") launches and held
        steps on this slice's paths: the binners, static, MLP-deform."""
        pick = lambda r: {"max_abs_err": max(r["err"].values()) if isinstance(r["err"], dict) else r["err"],
                          "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"]}
        return {"launches_binners": binners_launches[name], "launches_static": static_launches[name],
                "launches_mlpdeform": mlp_launches[name],
                "held_binners": {b: pick(binners_res[b][way]) for b in ("compact", "sort2")},
                "held_static": {k: pick(v) for k, v in static_held[name].items()},
                "held_mlpdeform": {k: pick(v) for k, v in mlp_held[name].items()}}

    # forward kernels: times per frame, launches of the serving run (and per
    # step of each training path); backward kernels: times per training
    # step, launches of the training run. A forward row's device operations
    # a call are counted in its profile.
    rows = []
    for name, replaces in (("blend_cm", "riggs_tpu/render/pallas_blend.py:179"),
                           ("blend_permuted_gm", "riggs_tpu/render/pallas_blend.py:602")):
        r = kres[name]
        rows.append({
            "name": name, "route": "cuda", "source": "riggs_tpu_torch/csrc/blend.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["err"].values()), "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "launches_per_frame": r["launches_per_frame"], "ms_per_launch": r["ms"] / r["launches_per_frame"],
            "launches_stage1": stage1_launches[name], "bound_term": r["bound_term"],
            "device_ops_per_call": r["device_ops_per_call"], "scratch_bytes_per_frame": r["scratch_bytes"],
            "started_chunks": r["started"], "active_chunks": r["active"],
            "ms_train": train_fwd[name]["ms"], "ms_stage1": stage1_fwd[name]["ms"],
            "bound_ms_stage1": stage1_fwd[name]["bound_ms"], "launches_loop": loop_launches[name],
            "held_loop": held(name), "launches_pipeline": pipe_launches[name], "held_pipeline": held(name, pipe_held),
            "launches_io": io_launches[name], "launches_flow": flow_launches[name], "held_flow": held(name, flow_held),
            "launches_zju": zju_launches[name], "held_zju": held(name, zju_held),
            "launches_refpoint": refpoint_launches[name],
            "launches_fps_twin": viewer["fps"]["plain windows"]["launches"].get(name, 0),
            "launches_fps_twin_ladder": viewer["fps"]["ladder"]["launches"].get(name, 0),
            "launches_edit": edit["launches"].get(name, 0), "launches_viewer": viewer["launches"].get(name, 0),
            "held_viewer": view_held(viewer, name), "held_edit": view_held(edit, name),
            **bench_rows(name),
            **({"launches_phase_a": pa_launches[name], "ms_phase_a": pa_fwd[name]["ms"],
                "launches_anim": anim["launches"].get(name, 0),
                "bound_ms_phase_a": pa_fwd[name]["bound_ms"], "plain_ms_phase_a": pa_fwd[name]["plain_ms"],
                "held_io": {"max_abs_err": max(io_held["err"].values()), "ms": io_held["ms"],
                            "plain_ms": io_held["plain_ms"], "bound_ms": io_held["bound_ms"]},
                **side_rows(name, "fwd")}
               if name == "blend_cm" else {}),
        })
    for name, replaces in (("blend_cm_bwd", "riggs_tpu/render/pallas_blend.py:221"),
                           ("blend_permuted_gm_bwd", "riggs_tpu/render/pallas_blend.py:638")):
        r = bres[name]
        rows.append({
            "name": name, "route": "cuda", "source": "riggs_tpu_torch/csrc/blend.cu",
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "launches_per_step": r["launches_per_step"], "ms_per_launch": r["ms"] / r["launches_per_step"],
            "max_rel_column_err": r["rel"], "launches_stage1": stage1_launches[name],
            "bound_term": r["bound_term"], "ms_stage1": stage1_bwd[name]["ms"],
            "bound_ms_stage1": stage1_bwd[name]["bound_ms"], "launches_loop": loop_launches[name],
            "held_loop": held(name), "launches_pipeline": pipe_launches[name], "held_pipeline": held(name, pipe_held),
            "launches_io": io_launches[name], "launches_flow": flow_launches[name], "held_flow": held(name, flow_held),
            "launches_zju": zju_launches[name], "held_zju": held(name, zju_held),
            "launches_refpoint": refpoint_launches[name], **bench_rows(name),
            **({"launches_phase_a": pa_launches[name], "ms_phase_a": pa_bwd[name]["ms"],
                "bound_ms_phase_a": pa_bwd[name]["bound_ms"], "plain_ms_phase_a": pa_bwd[name]["plain_ms"],
                **side_rows(name, "bwd")}
               if name == "blend_cm_bwd" else {}),
        })
    # the runs pair: the forward per frame, the backward per gradient, the
    # launches of the [runs] run
    r = runs_fwd
    rows.append({
        "name": "blend_runs", "route": "cuda", "source": "riggs_tpu_torch/csrc/blend.cu",
        "replaces": "riggs_tpu/render/pallas_blend.py:347", "launches": runs_launches["blend_runs"],
        "max_abs_err": max(r["err"].values()), "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        "launches_per_frame": r["launches_per_frame"], "bound_term": r["bound_term"],
        "device_ops_per_call": r["device_ops_per_call"], "scratch_bytes_per_frame": r["scratch_bytes"],
        "started_chunks": r["started"], "active_chunks": r["active"],
    })
    r = runs_bwd
    rows.append({
        "name": "blend_runs_bwd", "route": "cuda", "source": "riggs_tpu_torch/csrc/blend.cu",
        "replaces": "riggs_tpu/render/pallas_blend.py:379", "launches": runs_launches["blend_runs_bwd"],
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        "launches_per_step": r["launches_per_step"], "max_rel_column_err": r["rel"],
        "bound_term": r["bound_term"],
    })
    # the rotation fit: no Pallas kernel (stock ops and an SVD in riggs_tpu,
    # C2a). The fused entry: times on the loop's last held phase-B step (a
    # call's ms by CUDA events as every row, its device ms a launch back to
    # back beside it), launches of the loop; the covariance entry: times on
    # that step's covariances, launches of the loop (no caller on the port's
    # paths: p2dR and the ARAP editor are A10), held on every recorded fit
    # and on the planted ones
    r = loop_rot["phase B ladder it=39"]
    rot_runs = {"stage1": stage1_rot, "phase_a": pa_rot, **{f"loop {k}": v for k, v in loop_rot.items()},
                "flow": flow_rot, **{f"zju {k}": v for k, v in zju_rot.items()}, "hash arap_loss_with_rot": hash_rot,
                "edit optimize_weights": edit["est"]}
    per_path = lambda name: {"launches_stage1": stage1_launches[name], "launches_phase_a": pa_launches[name],
                             "launches_io": io_launches[name], "launches_flow": flow_launches[name],
                             "launches_zju": zju_launches[name], "launches_hash": hash_launches[name],
                             "launches_refpoint": refpoint_launches[name], "launches_dp1": dp1_launches[name]}
    rows.append({
        "name": "estimate_rotations", "route": "cuda", "source": "riggs_tpu_torch/csrc/rotfit.cu",
        "replaces": "riggs_tpu/ops/arap.py:60",
        "replaces_kind": "stock ops in riggs_tpu (gathers, einsum, jnp.linalg.svd), C2a",
        "launches": loop_launches["estimate_rotations"], "max_abs_err": max(v["err"] for v in rot_runs.values()),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "device_ms": r["device_ms"], "floor_ms": r["floor_ms"],
        "floor_device_ms": r["floor_device_ms"], "before_ms": r["before_ms"], "batch": r["batch"], "K": r["K"],
        **per_path("estimate_rotations"), "launches_edit": edit["launches"]["estimate_rotations"],
        "planted": stage1_rot["planted_edges"], "max_det_err": max(v["det_err"] for v in rot_runs.values()),
        "sweeps": {k: v["sweeps"] for k, v in rot_runs.items()},
        "held": {k: {key: v[key] for key in ("fits", "ill_posed", "err", "scaled_err", "ms", "device_ms",
                                             "before_ms", "plain_ms", "library_ms", "bound_ms")}
                 for k, v in rot_runs.items()},
    })
    # the covariance entry: launches and times of [anim] (p2dR's fit, its
    # one caller on a path), the loop's held step's covariances beside them
    a = anim["rot"]
    rows.append({
        "name": "fit_rotations", "route": "cuda", "source": "riggs_tpu_torch/csrc/rotfit.cu",
        "replaces": "riggs_tpu/ops/geometry.py:33", "replaces_kind": "stock op in riggs_tpu (jnp.linalg.svd), C2a",
        "launches": anim["launches"]["fit_rotations"],
        "max_abs_err": max([a["err"], edit["cov"]["err"]] + [v["cov_err"] for v in rot_runs.values()]),
        "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
        "library_ms": a["library_ms"], "device_ms": a["device_ms"], "batch": a["batch"], "max_det_err": a["det_err"],
        "launches_anim": anim["launches"]["fit_rotations"], "launches_edit": edit["launches"]["fit_rotations"],
        "ms_edit": edit["cov"]["ms"], "device_ms_edit": edit["cov"]["device_ms"],
        "plain_ms_edit": edit["cov"]["plain_ms"], "library_ms_edit": edit["cov"]["library_ms"],
        "bound_ms_edit": edit["cov"]["bound_ms"], "batch_edit": edit["cov"]["batch"], **per_path("fit_rotations"),
        "ms_loop": r["cov_ms"], "plain_ms_loop": r["cov_plain_ms"], "bound_ms_loop": r["cov_bound_ms"],
        "library_ms_loop": r["cov_library_ms"], "device_ms_loop": r["cov_device_ms"], "batch_loop": r["batch"],
        "planted": stage1_rot["planted"],
        "held": {"anim p2dR": a["err"], "edit deform_arap": edit["cov"]["err"],
                 **{k: v["cov_err"] for k, v in rot_runs.items()}},
    })
    # the offset entry: times on the second shard of a 2-way split of the
    # serving frame's tiles ([edges]), launches of [tileshard]'s 1 x 2 steps
    for name, r, replaces in (("blend_cm_offset", off_fwd, "riggs_tpu/render/pallas_blend.py:955"),
                              ("blend_cm_offset_bwd", off_bwd, "riggs_tpu/render/pallas_blend.py:969")):
        rows.append({
            "name": name, "route": "cuda", "source": "riggs_tpu_torch/csrc/blend.cu", "replaces": replaces,
            "launches": ts_launches[name], "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "bound_term": r["bound_term"], "launches_per_step": ts_per_step[name],
            "shard_tiles": OFFSET_SHARDS[-1][1], "shard_offset": OFFSET_SHARDS[-1][0],
            **({"max_rel_column_err": r["rel"]} if "rel" in r else {}),
        })
    print(f"[time] every phase's wall seconds {json.dumps({k: round(v, 1) for k, v in laps.items()})}; "
          f"{sum(laps.values()):.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
