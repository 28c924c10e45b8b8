"""scripts/torch_bench.py, the port's twin of bench.py, against bench.py and
riggs_tpu: its scene bit for bit; its gradient step (tiers, with its ladder
and with --no-ladder) against jax.grad of riggs_tpu's rasterize_tiled with
the same arguments, the Pallas blend in interpret mode, at 64 x 64 and
2 000 Gaussians; its step reading nothing from the device on the host; its
main() printing bench.py's JSON line last.

bench.py's scene comes from a subprocess: importing bench.py points jax's
compilation cache at .jax_cache for the rest of the importing process.

Tolerances: the scene exactly; image 3e-5, depth 2e-4 (the render tests'
bounds); each gradient column within 5e-5 absolute (the binners' tests'
bound) and within 1e-3 of its largest reference value (the backward
kernels' per-column bound).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riggs_tpu.camera import make_camera as j_make_camera
from riggs_tpu.render.ladder import make_tile_ladder as j_make_tile_ladder
from riggs_tpu.render.tiles import rasterize_tiled as j_rasterize
from riggs_tpu_torch.render.tiles import rasterize_tiled as t_rasterize
from scripts import torch_bench
from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_sync import _assert_no_reads, _guarded, plain_blends_exempt  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--size", "64", "--gaussians", "2000"]
NAMES = ("means", "colors", "opacity", "scales", "rots")


def test_scene_is_bench_scenes_bitwise(tmp_path):
    out = tmp_path / "scene.npz"
    code = ("import sys, numpy as np; sys.path.insert(0, '.'); import bench; "
            f"np.savez({str(out)!r}, *[np.asarray(a) for a in bench.build_scene(100_000)])")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr
    ref = np.load(out)
    mine = torch_bench.build_scene(100_000)
    for i, (a, name) in enumerate(zip(mine, NAMES)):
        b = ref[f"arr_{i}"]
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_columns(mine, ref, name):
    """Each column (the last axis) within 5e-5 absolute and 1e-3 of its
    largest reference value."""
    mine, ref = mine.reshape(ref.shape[0], -1), ref.reshape(ref.shape[0], -1)
    err = np.abs(mine - ref).max(0)
    scale = np.abs(ref).max(0)
    assert (scale > 0).all(), name
    assert (err <= 5e-5).all() and (err <= 1e-3 * scale).all(), f"{name}: max|d| {err}, column max {scale}"


@pytest.mark.parametrize("ladder", [True, False], ids=["ladder", "no_ladder"])
def test_grad_step_matches_reference(ladder):
    args = torch_bench.parse_args(SMALL + ([] if ladder else ["--no-ladder"]))
    cam, inputs, bg, extra = torch_bench.setup(args, torch.device("cpu"))
    jc = j_make_camera(np.eye(3), np.array([0, 0, 2.5]), 64, 64, fovx=0.9, fovy=0.9)
    jx = tuple(jnp.asarray(a) for a in torch_bench.build_scene(2000))
    jextra = dict(max_per_tile=640, max_tiles_per_gaussian=4, mid_cap=8192, mid_side=4)
    assert {k: v for k, v in extra.items() if k != "tile_ladder"} == jextra
    if ladder:
        probe = jax.jit(lambda *x: j_rasterize(jc, *x, jnp.zeros(3), blend="pallas", **jextra))(*jx)
        jextra["tile_ladder"] = j_make_tile_ladder(np.asarray(probe["tile_counts"]), n_buckets=6, margin=1.0,
                                                   min_cap=0)
        assert extra["tile_ladder"] == jextra["tile_ladder"] and len(jextra["tile_ladder"]) > 1

    def jloss(*x):
        out = j_rasterize(jc, *x, jnp.zeros(3), blend="pallas", **jextra)
        return jnp.mean(out["image"]) + jnp.mean(out["depth"]) * 0.0, out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*jx)
    assert int(jout["overflow"]) == 0 and int(jout["max_count"]) > 128  # more than one chunk, nothing truncated
    with torch.no_grad():
        tout = t_rasterize(cam, *inputs, bg, **extra)
    np.testing.assert_allclose(tout["image"].numpy(), np.asarray(jout["image"]), atol=3e-5, rtol=0)
    np.testing.assert_allclose(tout["depth"].numpy(), np.asarray(jout["depth"]), atol=2e-4, rtol=0)
    tg = torch_bench.grad_step(cam, inputs, bg, extra)
    for a, b, name in zip(tg, jg, NAMES):
        _assert_columns(a.numpy(), np.asarray(b), name)


def test_grad_step_reads_nothing_on_the_host(plain_blends_exempt):
    args = torch_bench.parse_args(SMALL)
    cam, inputs, bg, extra = torch_bench.setup(args, torch.device("cpu"))
    _, hits = _guarded(lambda: torch_bench.grad_step(cam, inputs, bg, extra))
    _assert_no_reads(hits, "torch_bench.grad_step")


def test_main_prints_bench_line_last(capsys):
    torch_bench.main(SMALL + ["--iters", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == "rasterizer_fwd_bwd_pixels_per_s_per_chip" and last["unit"] == "pixels/s"
    assert last["value"] > 0 and last["vs_baseline"] == round(last["value"] / 64e6, 4)
    assert lines[0].startswith("ladder: ((") and lines[-2].startswith("launches: ")
