"""Skeleton extraction in riggs_tpu and in riggs_tpu_torch on identical
numpy inputs: Prim's MST and build_tree, then obtain_skeleton_tree and its
stages on the fixtures of tests/test_skeleton.py.

Tolerance: none. Parents, trees, joint indices and the joints themselves
are exactly equal (the same numpy arithmetic on the same inputs).

The reference's build_tree runs its native C++ Prim (float32 keys, the
first strict minimum) whenever that library loads; the port keeps the numpy
Prim and casts the cost to float32 first. A planted cost matrix with a
near-tie that float64 splits and float32 does not shows the port following
the native choice.
"""
from unittest import mock

import numpy as np
import pytest
import torch

from riggs_tpu import native as JNative
from riggs_tpu.skeleton import extract as JX
from riggs_tpu.skeleton import mst as JMST
from riggs_tpu_torch.skeleton import extract as TX
from riggs_tpu_torch.skeleton import mst as TMST

from tests import test_skeleton as fixtures


class _PortOnCpu:
    """The port's extraction module with obtain_skeleton_tree's FPS on the
    CPU (its default is the card)."""

    def __getattr__(self, name):
        return getattr(TX, name)

    @staticmethod
    def obtain_skeleton_tree(*a, **k):
        return TX.obtain_skeleton_tree(*a, fps_fn=TX.fps_on("cpu"), **k)


def _cost(seed, k=24):
    pts = np.random.default_rng(seed).normal(size=(k, 3))
    return np.linalg.norm(pts[:, None] - pts[None], axis=-1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prim_and_build_tree_match_native_and_numpy(seed):
    cost = _cost(seed)
    assert JNative.available()
    np.testing.assert_array_equal(TMST.prim_mst(cost, 0), JMST.prim_mst(cost, 0))
    np.testing.assert_array_equal(TMST.build_tree(cost), JMST.build_tree(cost))
    np.testing.assert_array_equal(TMST.build_tree(cost), JNative.prim_mst(np.float32(cost), 2))
    np.testing.assert_array_equal(TMST.build_tree(cost), JMST.prim_mst(np.float32(cost), 2))
    # a disconnected remainder (zero costs are no edge) stops the tree
    cut = cost.copy()
    cut[:, 20:] = cut[20:, :] = 0.0
    np.testing.assert_array_equal(TMST.build_tree(cut), JMST.build_tree(cut))
    assert (TMST.build_tree(cut)[20:] == -1).all()


def test_build_tree_follows_the_native_float32_choice_on_a_near_tie():
    """From root 2, nodes 0 and 1 cost 1 + 1e-12 and 1: float64 takes 1
    first, float32 sees a tie and takes 0, and the two trees differ."""
    cost = np.full((4, 4), 10.0)
    np.fill_diagonal(cost, 0.0)
    for a, b, c in ((2, 0, 1.0 + 1e-12), (2, 1, 1.0), (0, 3, 0.5), (1, 3, 0.5)):
        cost[a, b] = cost[b, a] = c
    f64 = JMST.prim_mst(cost, 2)
    native = JNative.prim_mst(cost, 2)
    np.testing.assert_array_equal(f64, [3, 2, -1, 1])
    np.testing.assert_array_equal(native, [2, 3, -1, 0])
    np.testing.assert_array_equal(TMST.build_tree(cost), native)
    np.testing.assert_array_equal(TMST.build_tree(cost), JMST.build_tree(cost))
    np.testing.assert_array_equal(TMST.prim_mst(cost, 2), f64)  # the numpy Prim itself keeps its dtype


def _plus(labels):
    nodes, traj, lab = fixtures.make_synthetic_trajectories()
    return lambda X: X.obtain_skeleton_tree(nodes, traj, lab if labels else None)


def _chain(**kw):
    nodes = np.stack([np.zeros(64), np.linspace(-1, 1, 64), np.zeros(64)], -1).astype(np.float32)
    traj = fixtures.TestTopologies._animate(nodes)
    return lambda X: X.obtain_skeleton_tree(nodes, traj, **kw)


def _star():
    arms = [np.linspace(0.15, 1.0, 10)[:, None] * np.array([np.cos(a), np.sin(a), 0.0])
            for a in 2 * np.pi * np.arange(5) / 5]
    nodes = np.concatenate([[[0.0, 0, 0]]] + arms).astype(np.float32)
    traj = fixtures.TestTopologies._animate(nodes, amp=0.1)
    return lambda X: X.obtain_skeleton_tree(nodes, traj, leaf_prune_hops=2, simplify_dist_thres=0.3)


def _biped():
    spine = np.stack([np.zeros(12), np.linspace(-0.2, 1.0, 12), np.zeros(12)], -1)

    def limb(ox, oy, dx, dy, n=8):
        t = np.linspace(0.08, 0.7, n)
        return np.stack([ox + dx * t, oy + dy * t, np.zeros(n)], -1)

    nodes = np.concatenate([spine, limb(0, 1.0, 0.8, -0.2), limb(0, 1.0, -0.8, -0.2), limb(0, -0.2, 0.5, -0.9),
                            limb(0, -0.2, -0.5, -0.9)]).astype(np.float32)
    traj = fixtures.TestTopologies._animate(nodes, amp=0.12)
    return lambda X: X.obtain_skeleton_tree(nodes, traj, leaf_prune_hops=2, simplify_dist_thres=0.3)


def _dangles():
    """A chain 0..8 with a 2-node dangle off node 3: prune_tree, then the
    whole extraction on the same nodes."""
    parents = [-1, 0, 1, 2, 3, 4, 5, 6, 7, 3, 9]
    nodes = np.zeros((11, 3))
    nodes[:9, 0] = np.arange(9)
    nodes[9] = [3, 1, 0]
    nodes[10] = [3, 2, 0]
    traj = np.tile(nodes[None], (2, 1, 1))
    return lambda X: (X.prune_tree(nodes.copy(), traj, parents), X.obtain_skeleton_tree(nodes, traj))


def _dissolve(ys):
    x = np.arange(5, dtype=np.float32)
    pts = np.stack([x, np.asarray(ys, np.float32), np.zeros(5, np.float32)], -1)[None]
    tree, joints = np.array([-1, 0, 1, 2, 3]), np.array([-1, -2, 0, -2, 2])
    return lambda X: (X.dissolve_degree2_joints(pts, tree, joints, 0.1),
                      X.obtain_skeleton_tree(pts[0], np.concatenate([pts, pts + 0.01])))


def _repair():
    n = 11
    x = np.arange(n, dtype=np.float32)
    z = np.zeros(n, np.float32)
    z[9] = 2.25
    pts = np.stack([x, np.minimum(x, 10 - x) * 0.5, z], -1)[None]
    return lambda X: (X.compute_insert_points(list(range(n)), pts, 2.3, 5),
                      X.obtain_skeleton_tree(pts[0], np.concatenate([pts, pts * 1.01])))


def _fps():
    """More nodes than candidates: the FPS path (the reference's JAX FPS,
    the port's torch FPS on the CPU)."""
    nodes = np.stack([np.zeros(64), np.linspace(-1, 1, 64), np.zeros(64)], -1).astype(np.float32)
    traj = fixtures.TestTopologies._animate(nodes)
    return lambda X: X.obtain_skeleton_tree(nodes, traj, max_candidates=40, simplify_dist_thres=0.05)


FIXTURES = {
    "chain": lambda: _chain(),
    "chain fine": lambda: _chain(simplify_dist_thres=0.05),
    "star": _star,
    "biped": _biped,
    "plus": lambda: _plus(False),
    "semantics": lambda: _plus(True),
    "short dangles": _dangles,
    "collinear joint": lambda: _dissolve([0.0, 0.0, 0.0, 0.0, 0.0]),
    "bent joint": lambda: _dissolve([0.0, 0.0, 0.5, 0.0, 0.0]),
    "feasibility repair": _repair,
    "fps candidates": _fps,
}


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _flat(o)]
    return [np.asarray(out)]


@pytest.mark.parametrize("name", list(FIXTURES))
def test_extraction_matches_exactly(name):
    run = FIXTURES[name]()
    ref, port = _flat(run(JX)), _flat(run(_PortOnCpu()))
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_extraction_samples_its_candidates_on_the_card_by_default():
    """With no fps_fn, more nodes than candidates take the FPS to cuda,
    which raises where CUDA is absent (no silent CPU sampling)."""
    nodes = np.stack([np.zeros(64), np.linspace(-1, 1, 64), np.zeros(64)], -1).astype(np.float32)
    traj = fixtures.TestTopologies._animate(nodes)
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TX.obtain_skeleton_tree(nodes, traj, max_candidates=40)
