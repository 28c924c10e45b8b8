"""Functional Adam with per-leaf learning rates over a tree of tensors.

Port of ``riggs_tpu/train/optim.py:24-101`` (Adam and ``zero_rows``). Parameters, gradients and both
moments are trees of nested dicts and lists with tensor leaves, the
reference's pytrees; ``lrs`` and ``update_mask`` may be a scalar or a prefix
of that tree (one value per parameter group). A functional optimizer rather
than ``torch.optim``: the moments are carried in the training state and
compared with the reference's leaf by leaf. The update runs without autograd
and returns new tensors; the caller writes them back
(``Gaussians.replace_params``, ``SkeletonWarp.replace_params``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over trees of one structure (dicts, lists,
    tuples; every other value is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def named_leaves(tree: Any, key: str, out: dict) -> dict:
    """Add a ``params_dict``-form tree's leaves to ``out`` under the keys
    ``jax.tree_util.keystr`` gives them (``key['layers'][0]['w']``): key ->
    (leaf, whether it is stored transposed: the ``w`` of a ``{"w", "b"}``
    pair is an ``nn.Linear`` weight). Returns ``out``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                out[f"{key}['{k}']"] = (v, k == "w" and set(tree) == {"w", "b"})
            else:
                named_leaves(v, f"{key}['{k}']", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            named_leaves(v, f"{key}[{i}]", out)
    else:
        raise TypeError(f"{key}: unexpected {type(tree).__name__} in a parameter tree")
    return out


def named_fields(obj: Any, names, key: str, out: dict) -> dict:
    """``named_leaves`` of the tensor fields ``names`` of ``obj``
    (``key.name``)."""
    for name in names:
        out[f"{key}.{name}"] = (getattr(obj, name), False)
    return out


def grad_tree(loss: torch.Tensor, tree: Any) -> Any:
    """d loss / d every leaf of ``tree`` (``jax.grad``'s output tree), zeros
    where a leaf does not reach the loss."""
    leaves = tree_leaves(tree)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)])
    return tree_map(lambda _: next(it), tree)


def _broadcast_prefix(prefix: Any, tree: Any) -> Any:
    """Expand a prefix of ``tree`` (a scalar for a whole subtree) to its full
    structure."""
    if isinstance(prefix, dict):
        return {k: _broadcast_prefix(prefix[k], v) for k, v in tree.items()}
    if isinstance(prefix, (list, tuple)):
        return type(tree)(_broadcast_prefix(p, v) for p, v in zip(prefix, tree))
    return tree_map(lambda _: prefix, tree)


@dataclasses.dataclass
class AdamState:
    mu: Any
    nu: Any
    count: torch.Tensor  # () int32


def adam_leaves(opt: AdamState, key: str, out: dict) -> dict:
    """``named_leaves`` of an Adam state (``key.mu...``, ``key.nu...``,
    ``key.count``)."""
    named_leaves(opt.mu, f"{key}.mu", out)
    named_leaves(opt.nu, f"{key}.nu", out)
    return named_fields(opt, ("count",), key, out)


def adam_init(params: Any) -> AdamState:
    leaf = tree_leaves(params)[0]
    z = lambda p: torch.zeros_like(p, requires_grad=False)
    return AdamState(mu=tree_map(z, params), nu=tree_map(z, params),
                     count=torch.zeros((), dtype=torch.int32, device=leaf.device))


@torch.no_grad()
def adam_update(
    grads: Any,
    state: AdamState,
    params: Any,
    lrs: Any,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    update_mask: Any = None,
) -> tuple[Any, AdamState]:
    """One Adam step; returns (new params, new state). ``update_mask``: a
    False leaf (or group) freezes that leaf entirely, params and moments."""
    count = state.count + 1
    c1 = 1.0 - b1 ** count.to(torch.float32)
    c2 = 1.0 - b2 ** count.to(torch.float32)

    def leaf(g, mu, nu, p, lr, m):
        new_mu = b1 * mu + (1 - b1) * g
        new_nu = b2 * nu + (1 - b2) * g * g
        step = lr * (new_mu / c1) / (torch.sqrt(new_nu / c2) + eps)
        if m is not None:
            keep = torch.as_tensor(m, device=p.device)
            new_mu = torch.where(keep, new_mu, mu)
            new_nu = torch.where(keep, new_nu, nu)
            step = torch.where(keep, step, 0.0)
        return p - step, new_mu, new_nu

    out = tree_map(
        leaf, grads, state.mu, state.nu, params, _broadcast_prefix(lrs, params),
        _broadcast_prefix(update_mask, params),
    )
    return _pick(out, 0), AdamState(mu=_pick(out, 1), nu=_pick(out, 2), count=count)


def _pick(tree: Any, i: int) -> Any:
    """Element ``i`` of the (p, mu, nu) triple at every leaf of ``tree``
    (parameter trees nest dicts and lists only)."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def zero_rows(state: AdamState, dest: torch.Tensor) -> AdamState:
    """Zero the moments of capacity rows ``dest`` (fresh state for newly
    placed Gaussians); rows at or past the capacity are dropped and scalar
    leaves are left alone."""

    def z(a):
        if a.dim() == 0:
            return a
        C = a.shape[0]
        idx = torch.where((dest >= 0) & (dest < C), dest, C).to(torch.int64)
        return torch.cat([a, a[:1]]).index_fill_(0, idx, 0.0)[:C]

    return AdamState(mu=tree_map(z, state.mu), nu=tree_map(z, state.nu), count=state.count)
