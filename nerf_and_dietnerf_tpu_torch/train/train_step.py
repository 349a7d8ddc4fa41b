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

Over a data-parallel group (``mesh``, a ``parallel.mesh.DataGroup``) a rank
computes the single-device step's numbers for its rows of the global batch:
every rank draws the same permutation and the step's uniforms at the global
batch's shape and keeps its rows; the gradient is averaged over the ranks by
one all-reduce (the logged loss and MSEs in the same buffer) before the clip
and Adam, so every rank applies the same update to its replicated state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from nerf_and_dietnerf_tpu_torch.models import nerf
from nerf_and_dietnerf_tpu_torch.models.nerf import NeRFConfig
from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib
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


def group_draws(key, config: NeRFConfig, mesh, rows: int, has_fine: bool, device):
    """This rank's rows of the step's uniforms, drawn at the global batch's
    shape (``rows`` a rank, ``world_size`` ranks) from ``key``."""
    lo = mesh.rank * rows
    draws = nerf.draw_training_uniforms(key, config, rows * mesh.world_size, has_fine, device)
    return {k: v[lo:lo + rows] for k, v in draws.items()}


def reduce_over_group(grads: Params, scalars: Dict[str, torch.Tensor], mesh):
    """Average ``grads`` and the scalar ``scalars`` over the ranks with one
    all-reduce of one flat buffer; returns them."""
    leaves = tree_leaves(grads)
    names = list(scalars)
    stacked = torch.stack([scalars[k].to(leaves[0].dtype) for k in names])
    mesh_lib.all_reduce_mean_(leaves + [stacked], mesh)
    return tree_unflatten(grads, leaves), dict(zip(names, stacked.unbind()))


def train_step(state: TrainState, key, batch, *, config: NeRFConfig, optimizer: Adam,
               draws=None, mesh=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step on a ray batch ``(origins, directions, rgb)``; ``key`` is a
    ``torch.Generator`` on the batch's device. With ``mesh``, the batch is
    this rank's rows of the global batch (:func:`run_epoch`) and the step is
    the single-device step's for them (the module docstring)."""
    orig, dirs, rgb = batch
    if mesh is None:
        _, metrics, grads = loss_and_grads(
            state.params,
            lambda p: nerf.training_losses(p, config, key, orig, dirs, rgb, draws=draws),
        )
    else:
        if draws is None:
            draws = group_draws(key, config, mesh, orig.shape[0],
                                state.params.get("fine") is not None, orig.device)
        loss, mses, grads = loss_and_grads(
            state.params,
            lambda p: nerf.training_mses(p, config, key, orig, dirs, rgb, draws=draws))
        grads, scalars = reduce_over_group(grads, dict(mses, loss=loss), mesh)
        metrics = nerf.metrics_of(scalars.pop("loss"), scalars)
    updates, opt_state = optimizer.update(grads, state.opt_state)
    return TrainState(apply_updates(state.params, updates), opt_state, state.step + 1), metrics


def run_epoch(state: TrainState, key, tables, n_batches: int, batch_size: int, step, mesh=None):
    """A permutation of the ray table ``tables`` (origins, dirs, rgb) drawn
    from ``key`` on the device, then ``n_batches`` calls of
    ``step(state, batch, i) -> (state, metrics)`` on gathered batches (with
    ``mesh``: this rank's rows of each, ``parallel.mesh.batch_indices``);
    returns the state and the mean of each metric."""
    perm = torch.randperm(tables[0].shape[0], generator=key, device=tables[0].device)
    where = () if mesh is None else (mesh.rank, mesh.world_size)
    history = []
    for i in range(n_batches):
        idx = mesh_lib.batch_indices(perm, i, batch_size, *where)
        state, metrics = step(state, tuple(t[idx] for t in tables), i)
        history.append(metrics)
    mean = {k: torch.stack([m[k] for m in history]).mean() for k in history[0]}
    return state, mean


def make_epoch_fn(config: NeRFConfig, optimizer: Adam, n_batches: int, batch_size: int,
                  mesh=None):
    """One epoch over a ray table on the device: a permutation drawn on the
    device, then ``n_batches`` steps, each on a gathered batch (with
    ``mesh``, this rank's rows of it).

    Returned callable: ``epoch_fn(state, key, origins, dirs, rgb) ->
    (state, mean_metrics)``, with ``key`` a ``torch.Generator`` on the tables'
    device (the permutation first, then each step's draws).
    """

    if mesh is not None:
        config = dataclasses.replace(config, mesh=mesh)

    def epoch_fn(state: TrainState, key, origins, dirs, rgb):
        return run_epoch(
            state, key, (origins, dirs, rgb), n_batches, batch_size,
            lambda state, batch, i: train_step(state, key, batch, config=config,
                                               optimizer=optimizer, mesh=mesh), mesh)

    return epoch_fn
