"""The work of a step or a frame, counted from its inputs: the FLOPs of
the skeleton model's GEMMs and skinning product, and the blend's
(Gaussian, pixel) pairs, bytes and least time on the card.

The rates and the per-pair operation counts are copied from
``chip_smoke.py`` (its ``_bound`` and the constants beside it); the pairs
are not the kernel's active chunks but what the inputs need: each pixel
walks its tile's Gaussians in depth order up to where its transmittance
falls below 1e-4 (``reference/render.py``), and a pair is a hit where the
alpha reaches 1/255.
"""
from __future__ import annotations

import torch

from portbench.reference import render as R

# NVIDIA H100 SXM: HBM 3.35 TB/s; FP32 instructions: 132 SMs x 128 lanes at
# 1.98 GHz, 33.5e12/s (the data sheet's 67 TFLOP/s counts an FMA as two);
# exp and log1p on the special-function unit, 16 per clock per SM, 4.18e12/s
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 33.5e12
SFU_OPS_PER_S = 4.18e12
FP32_FLOPS_PER_S = 67e12  # the peak that mfu.* divides by (TF32 is off in the port)
# forward: every pair needs the EWA power and the alpha test (16
# instructions, one exp); a hit also the transmittance update and the
# accumulation (13, a log1p and an exp). Backward: the same 16 a pair; a hit
# 38 (the transmittance, weights, the value dot dC, the running sum, the
# suffix, dalpha, dpower and the ten sums over the tile's pixels)
OPS_PER_PAIR = 16
OPS_PER_HIT = 13
OPS_PER_HIT_BWD = 38
SFU_PER_PAIR = 1
SFU_PER_HIT = 2
ROW_FLOATS = 10  # x, y, conic (3), opacity, rgb, depth
OUT_FLOATS = 5  # rgb, depth, alpha


def bound_ms(nbytes: float, ops: float, sfu: float) -> float:
    """The least time the card could take: the largest of the bytes over
    HBM, the FP32 instructions over their issue rate and the SFU
    operations over theirs."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_INSTR_PER_S, sfu / SFU_OPS_PER_S) * 1e3


@torch.no_grad()
def walk(packed: torch.Tensor, gid: torch.Tensor, starts: torch.Tensor, counts: torch.Tensor, tiles_x: int,
         width: int, height: int, budget: int = R.BLOCK_ELEMENTS) -> dict:
    """Pairs, hits and the rows each tile's deepest walk reads, from the
    tile lists of ``reference.render.render(..., with_lists=True)``."""
    dev = packed.device
    N = packed.shape[0] - 1
    gid_pad = torch.cat([gid, torch.full((1,), N, device=dev)])
    p = torch.arange(R.TILE * R.TILE, device=dev)
    pairs = hits = rows = 0
    for tids, n in R.blocks(counts, budget):
        tids = tids.to(dev)
        s = torch.arange(n, device=dev)[None]
        live = s < counts[tids][:, None]
        g = packed[torch.where(live, gid_pad[torch.clamp(starts[tids][:, None] + s, max=gid.numel())], N)]
        px = (((tids % tiles_x) * R.TILE)[:, None] + p % R.TILE)
        py = (((tids // tiles_x) * R.TILE)[:, None] + p // R.TILE)
        inside = ((px < width) & (py < height))[:, :, None]
        dx = px.to(torch.float32)[:, :, None] - g[:, None, :, 0]
        dy = py.to(torch.float32)[:, :, None] - g[:, None, :, 1]
        power = -0.5 * (g[:, None, :, 2] * dx * dx + g[:, None, :, 4] * dy * dy) - g[:, None, :, 3] * dx * dy
        alpha = torch.clamp(g[:, None, :, 5] * torch.exp(power), max=R.ALPHA_MAX)
        hit = (power <= 0.0) & (alpha >= R.ALPHA_MIN)
        P = torch.cumprod(1.0 - torch.where(hit, alpha, 0.0), dim=-1)
        # a pixel walks up to and including the Gaussian that ends it
        before_end = torch.cumsum((P < R.T_EPS).to(torch.int32), dim=-1) <= 1
        walked = before_end & live[:, None, :] & inside
        pairs += int(walked.sum())
        hits += int((walked & hit).sum())
        rows += int(walked.sum(dim=1).gt(0).sum())
    return {"pairs": pairs, "hits": hits, "rows": rows, "pixels": width * height, "tiles": int(counts.numel())}


def blend_bounds(w: dict) -> dict:
    """The least time of the forward and of the backward of one frame's blend."""
    fwd_bytes = w["rows"] * ROW_FLOATS * 4 + w["pixels"] * OUT_FLOATS * 4 + w["tiles"] * 4
    bwd_bytes = w["rows"] * ROW_FLOATS * 4 * 2 + w["pixels"] * OUT_FLOATS * 4 + w["tiles"] * 4
    sfu = w["pairs"] * SFU_PER_PAIR + w["hits"] * SFU_PER_HIT
    return {"blend_fwd": bound_ms(fwd_bytes, w["pairs"] * OPS_PER_PAIR + w["hits"] * OPS_PER_HIT, sfu),
            "blend_bwd": bound_ms(bwd_bytes, w["pairs"] * OPS_PER_PAIR + w["hits"] * OPS_PER_HIT_BWD, sfu)}


def blend_flops(w: dict, backward: bool) -> float:
    """The blend's FP32 instructions, each counted as one FLOP (an FMA as
    one: an undercount, never an overcount)."""
    f = w["pairs"] * OPS_PER_PAIR + w["hits"] * OPS_PER_HIT
    return f + (w["pairs"] * OPS_PER_PAIR + w["hits"] * OPS_PER_HIT_BWD if backward else 0)


def trunk_dims(d_in: int, width: int, depth: int) -> list[tuple[int, int]]:
    skip = depth // 2
    return [(d_in if i == 0 else width + d_in if i - 1 == skip else width, width) for i in range(depth)]


def skeleton_flops(cfg: dict, n_points: int, n_joints: int) -> float:
    """Forward FLOPs of the skeleton model on ``n_points`` points: the
    WeightMLP and the detail MLP on each point, the PoseMLP once, and the
    dense (N, bones) @ (bones, 16) skinning product."""
    s = cfg["skeleton"]
    W, D, B = s["width"], s["depth"], n_joints - 1
    weight = trunk_dims(3 * (2 * s["weight_multires"] + 1), W, D) + [(W, B)]
    detail = trunk_dims(3 * (2 * s["detail_multires"] + 1) + 4 * n_joints, W, D) + [(W, 3)]
    pose = trunk_dims(2 * s["pose_multires"] + 1, W, D) + [(W, 4 * n_joints), (W, 3)]
    per_point = sum(2 * a * b for a, b in weight + detail) + 2 * B * 16
    return float(n_points * per_point + sum(2 * a * b for a, b in pose))


def node_flops(cfg: dict, n_points: int) -> float:
    """Forward FLOPs of a phase-B step's node model: the DeformNetwork with
    its timenet on the nodes once for the warp and once at each of the two
    ARAP times, each point's distances to every node in (xyz, hyper
    coordinates) as a product, and its K-sparse blend of the nodes' 10
    channels."""
    n = cfg["nodes"]
    W, D, M, H, K = n["width"], n["depth"], n["node_num"], n["hyper_dim"], n["K"]
    trunk = trunk_dims(3 * (2 * n["x_multires"] + 1) + n["time_out"], W, D) + [(W, 3), (W, 3), (W, 4)]
    timenet = [(2 * n["t_multires"] + 1, 256), (256, n["time_out"])]
    per_row = sum(2 * a * b for a, b in trunk + timenet)
    return float(3 * M * per_row + n_points * (2 * (3 + H) * M + 2 * K * 10))
