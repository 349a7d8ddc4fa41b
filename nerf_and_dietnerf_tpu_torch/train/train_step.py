"""Training step: Adam on the coarse + fine MSE objective.

Port of ``nerf_and_dietnerf_tpu/train/train_step.py``. The optimizer is
written out to match ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8 added after
the square root, eps_root 0), optionally after ``clip_by_global_norm`` and
with a non-staircase ``exponential_decay`` learning rate. Master weights stay
f32; only the MLP's products run in the compute type (bf16 has the f32
exponent range, so there is no loss scaling).

The optimizer state is ``{"count": int, "mu": tree, "nu": tree}``; one count
serves both Adam's bias correction and the schedule, as optax's two counts
always agree (and are both set on an ``.h5`` resume).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from nerf_and_dietnerf_tpu_torch.models import nerf
from nerf_and_dietnerf_tpu_torch.models.nerf import NeRFConfig
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

Params = Dict[str, Any]


@dataclasses.dataclass
class TrainState:
    """Full training state: parameters, Adam moments and count, step."""

    params: Params
    opt_state: Dict[str, Any]
    step: int


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam`` with an optional exponential lr decay and global-norm
    clip, on trees of tensors."""

    learning_rate: float = 5e-4
    lr_final: Optional[float] = None
    total_steps: Optional[int] = None
    grad_clip_norm: Optional[float] = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def lr(self, count: int) -> float:
        """lr for the update at ``count`` (the count before this update)."""
        if self.lr_final is None:
            return self.learning_rate
        return self.learning_rate * (self.lr_final / self.learning_rate) ** (
            count / self.total_steps)

    def init(self, params: Params) -> Dict[str, Any]:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads: Params, opt_state: Dict[str, Any]):
        """``(updates, new_opt_state)``; add the updates to the params."""
        if self.grad_clip_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(grads)))
            clip = g_norm >= self.grad_clip_norm
            grads = tree_map(
                lambda g: torch.where(clip, g / g_norm * self.grad_clip_norm, g), grads)
        count = opt_state["count"]
        count_inc = count + 1
        c1 = 1.0 - self.b1 ** count_inc
        c2 = 1.0 - self.b2 ** count_inc
        lr = self.lr(count)
        mu = tree_map(lambda g, m: (1.0 - self.b1) * g + self.b1 * m, grads, opt_state["mu"])
        nu = tree_map(lambda g, v: (1.0 - self.b2) * (g * g) + self.b2 * v, grads,
                      opt_state["nu"])
        updates = tree_map(
            lambda m, v: (m / c1) / (torch.sqrt(v / c2) + self.eps) * -lr, mu, nu)
        return updates, {"count": count_inc, "mu": mu, "nu": nu}


def make_optimizer_with_schedule(learning_rate: float, lr_final: Optional[float] = None,
                                 total_steps: Optional[int] = None,
                                 grad_clip_norm: Optional[float] = None) -> Adam:
    """Adam with lr(t) = lr0 * (lr_final / lr0)^(t / T) when ``lr_final`` is set
    (constant lr otherwise, the reference's behaviour)."""
    if lr_final is not None and (not total_steps or total_steps <= 0):
        raise ValueError("lr_final requires a positive total_steps")
    return Adam(learning_rate, lr_final=lr_final, total_steps=total_steps,
                grad_clip_norm=grad_clip_norm)


def apply_updates(params: Params, updates: Params) -> Params:
    return tree_map(lambda p, u: (p + u).detach(), params, updates)


def init_train_state(generator: torch.Generator, config: NeRFConfig, optimizer: Adam,
                     device="cpu") -> TrainState:
    params = nerf.init_params(generator, config, device)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def loss_and_grads(params: Params, loss_fn):
    """``(loss, aux, grads)`` of ``loss_fn(params) -> (loss, aux)``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), aux, tree_unflatten(params, list(grads))


def train_step(state: TrainState, key, batch, *, config: NeRFConfig, optimizer: Adam,
               draws=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step on a ray batch ``(origins, directions, rgb)``; ``key`` is a
    ``torch.Generator`` on the batch's device."""
    orig, dirs, rgb = batch
    _, metrics, grads = loss_and_grads(
        state.params,
        lambda p: nerf.training_losses(p, config, key, orig, dirs, rgb, draws=draws),
    )
    updates, opt_state = optimizer.update(grads, state.opt_state)
    return TrainState(apply_updates(state.params, updates), opt_state, state.step + 1), metrics


def make_epoch_fn(config: NeRFConfig, optimizer: Adam, n_batches: int, batch_size: int):
    """One epoch over a ray table on the device: a permutation drawn on the
    device, then ``n_batches`` steps, each on a gathered batch.

    Returned callable: ``epoch_fn(state, key, origins, dirs, rgb) ->
    (state, mean_metrics)``, with ``key`` a ``torch.Generator`` on the tables'
    device (the permutation first, then each step's draws).
    """

    def epoch_fn(state: TrainState, key, origins, dirs, rgb):
        perm = torch.randperm(origins.shape[0], generator=key, device=origins.device)
        history = []
        for i in range(n_batches):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            batch = (origins[idx], dirs[idx], rgb[idx])
            state, metrics = train_step(state, key, batch, config=config, optimizer=optimizer)
            history.append(metrics)
        mean = {k: torch.stack([m[k] for m in history]).mean() for k in history[0]}
        return state, mean

    return epoch_fn

