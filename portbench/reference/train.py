"""The reference's training steps: the MSE objective and Adam, on batches and
draws the benchmark hands it.

Adam is optax's: b1 0.9, b2 0.999, eps 1e-8 added after the square root, a
constant learning rate. The loss of a step is the coarse plus the fine MSE
over the batch's rays and colour channels. The batch is taken in blocks of
rays, so that the reference fits beside nothing else on the device; that
does not change the numbers it computes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from reference import nerf

B1, B2, EPS = 0.9, 0.999, 1e-8


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def leaf_names(tree, prefix: str = "") -> List[str]:
    """The dotted path of each leaf, in :func:`leaves`' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree) for n in leaf_names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _rebuild(like, flat):
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def loss_and_grads(params, dims, batch: Dict, rnd, block: int = 1024):
    """``(loss, grads, z)`` of one step's objective, the grads in leaf order
    and ``z`` the reference's own resampled samples. With ``batch["z_follow"]``
    the fine pass runs on those samples, their gradient the reference's own
    resampling's (:func:`nerf.ray_sse`)."""
    flat = [p.detach().clone().requires_grad_(True) for p in leaves(params)]
    tree = _rebuild(params, flat)
    grads = [torch.zeros_like(p) for p in flat]
    n = batch["rgb"].shape[0]
    scale = 1.0 / (n * batch["rgb"].shape[1])
    follow = batch.get("z_follow")
    total, own = 0.0, []
    for lo in range(0, n, block):
        sl = slice(lo, min(lo + block, n))
        sse_c, sse_f, z = nerf.ray_sse(tree, dims, batch["o"][sl], batch["d"][sl],
                                       batch["rgb"][sl], batch["strat_u"][sl],
                                       batch["fine_u"][sl], rnd,
                                       None if follow is None else follow[sl])
        loss = (sse_c + sse_f) * scale
        for g, dg in zip(grads, torch.autograd.grad(loss, flat, allow_unused=True)):
            if dg is not None:
                g += dg
        total += float(loss.detach())
        own.append(z)
    return total, grads, torch.cat(own)


def run_steps(params, dims, batches: List[Dict], rnd, lr: float, fault: Optional[str] = None):
    """Adam over ``batches`` from ``params``: ``{"losses", "grad1", "change",
    "names", "z"}``, the first step's gradient and the parameters' change
    after the last step, by leaf, the leaves' names, and each step's
    resampled samples. ``fault`` plants a fault in place of the program:
    ``"unchanged_state"`` (no update), ``"half_batch"`` (each step's first
    half of the rays alone) or ``"trunk_grad_doubled"`` (every trunk
    layer's gradient twice its value)."""
    p0 = [p.detach().clone() for p in leaves(params)]
    names = leaf_names(params)
    twice = [fault == "trunk_grad_doubled" and n.split(".")[1] == "trunk" for n in names]
    p = [x.clone() for x in p0]
    mu = [torch.zeros_like(x) for x in p]
    nu = [torch.zeros_like(x) for x in p]
    losses, grad1, zs = [], None, []
    for step, batch in enumerate(batches):
        if fault == "half_batch":
            half = batch["rgb"].shape[0] // 2
            batch = {k: (v[:half] if torch.is_tensor(v) else v) for k, v in batch.items()}
        loss, g, z = loss_and_grads(_rebuild(params, p), dims, batch, rnd)
        g = [2.0 * x if t else x for x, t in zip(g, twice)]
        losses.append(loss)
        zs.append(z)
        if grad1 is None:
            grad1 = [x.clone() for x in g]
        c1, c2 = 1.0 - B1 ** (step + 1), 1.0 - B2 ** (step + 1)
        mu = [(1.0 - B1) * gi + B1 * m for gi, m in zip(g, mu)]
        nu = [(1.0 - B2) * (gi * gi) + B2 * v for gi, v in zip(g, nu)]
        if fault != "unchanged_state":
            p = [x + (m / c1) / (torch.sqrt(v / c2) + EPS) * -lr for x, m, v in zip(p, mu, nu)]
    return {"losses": losses, "grad1": grad1, "change": [x - x0 for x, x0 in zip(p, p0)],
            "names": names, "z": zs}
