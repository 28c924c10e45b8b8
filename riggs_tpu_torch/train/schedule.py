"""Learning-rate schedules as plain functions of the host iteration.

A copy of ``riggs_tpu/train/schedule.py`` (numpy only; the port keeps its own
copy rather than import the JAX package): ``expon_lr`` and ``linear_lr`` in
float64 as the reference's host loop uses them, ``landmark_interpolate``, and
``expon_lr_f32`` and ``landmark_interpolate_f32``, the counterparts of
``expon_lr_jit`` (:47-72) and ``landmark_interpolate_jit`` (:77-111), which
the reference evaluates on device in float32; the port's eager training
steps evaluate the same float32 arithmetic on the host.
"""
from __future__ import annotations

import numpy as np


def expon_lr(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0, max_steps=1_000_000):
    """Log-linear decay lr_init -> lr_final with optional sine delay ramp."""

    def helper(step):
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
                0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1)
            )
        else:
            delay = 1.0
        t = np.clip(step / max_steps, 0, 1)
        return float(delay * np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t))

    return helper


def linear_lr(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0, max_steps=1_000_000):
    def helper(step):
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
                0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1)
            )
        else:
            delay = 1.0
        t = np.clip(step / max_steps, 0, 1)
        return float(delay * (lr_init * (1 - t) + lr_final * t))

    return helper


def expon_lr_f32(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0, max_steps=1_000_000):
    """``expon_lr`` in float32 arithmetic, as ``expon_lr_jit`` computes it:
    returns ``fn(it) -> float`` (a float32 value)."""
    f32 = np.float32
    if lr_init == 0.0 and lr_final == 0.0:
        return lambda it: 0.0

    def helper(it):
        step = f32(it)
        if lr_delay_steps > 0:
            delay = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
                f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps), f32(0.0), f32(1.0))
            )
        else:
            delay = f32(1.0)
        t = np.clip(step / f32(max_steps), f32(0.0), f32(1.0))
        return float(f32(delay * np.exp(f32(np.log(lr_init)) * (f32(1) - t) + f32(np.log(lr_final)) * t)))

    return helper


def landmark_interpolate_f32(landmarks, steps, it, interpolation="log") -> float:
    """``landmark_interpolate`` in float32 arithmetic, as
    ``landmark_interpolate_jit`` computes it (a float32 value)."""
    f32 = np.float32
    steps_f = [float(s) for s in steps]
    step = f32(it)
    stage = int(sum(step >= f32(s) for s in steps_f))
    if stage == len(steps_f):
        return float(f32(max(0.0, float(landmarks[-1]))))
    if stage == 0:
        return 0.0
    l1, l2 = float(landmarks[stage - 1]), float(landmarks[stage])
    if l2 <= 0:
        return 0.0
    s1, s2 = steps_f[stage - 1], steps_f[stage]
    ratio = (step - f32(s1)) / f32(s2 - s1)
    if interpolation == "log":
        l1s = max(l1, 1e-30)
        return float(np.exp(f32(np.log(l1s)) * (f32(1) - ratio) + f32(np.log(l2)) * ratio))
    if interpolation == "linear":
        return float(f32(f32(l1) * (f32(1) - ratio) + f32(l2) * ratio))
    raise NotImplementedError(f"Unknown interpolation: {interpolation}")


def landmark_interpolate(landmarks, steps, step, interpolation="log"):
    """Piecewise interpolation of a lambda over training-step landmarks:
    0 before the first landmark, max(0, last) after the last, log- or
    linear-interpolated between."""
    stage = int((step >= np.asarray(steps)).sum())
    if stage == len(steps):
        return max(0, landmarks[-1])
    if stage == 0:
        return 0
    l1, l2 = landmarks[stage - 1], landmarks[stage]
    if l2 <= 0:
        return 0
    s1, s2 = steps[stage - 1], steps[stage]
    ratio = (step - s1) / (s2 - s1)
    if interpolation == "log":
        return float(np.exp(np.log(l1) * (1 - ratio) + np.log(l2) * ratio))
    if interpolation == "linear":
        return float(l1 * (1 - ratio) + l2 * ratio)
    raise NotImplementedError(f"Unknown interpolation: {interpolation}")
