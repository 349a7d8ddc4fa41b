"""DietNeRF: NeRF + semantic-consistency regularization for few-shot scenes.

Port of ``nerf_and_dietnerf_tpu/models/dietnerf.py`` (reference
``src/DietNeRF.py``). Every 13th step renders a low-res image from a random
novel pose inside the differentiated region and pulls its ViT embedding
toward the embedding of a random training image:

- interval K = 13, weight 0.1, active for the first 95 % of the steps;
- the consistency render: 150x150, 55 coarse + 55 fine samples, the render
  path's merged fine z, in 2,500-ray chunks;
- loss = ``0.1 * (1 - cos(render_emb, target_emb)) / 2``;
- the novel pose: a jittered sphere camera around the scene's point of
  interest when the scene is spherical, else a slerp blend of three dataset
  poses (:class:`PoseSampler`, numpy, the JAX package's seeds and draws).

The render is chunked through ``torch.utils.checkpoint`` so the backward
keeps one chunk's activations at a time. A checkpointed function is run
again in the backward, and ``checkpoint`` restores only the global RNG
state, not an explicit ``torch.Generator``: each chunk's stratified and
resampling uniforms are therefore drawn from the step's generator before the
checkpointed call and passed in, so the recompute sees the forward's z.
The diet step is picked on the host by the step counter (the JAX package's
``lax.cond``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint

from nerf_and_dietnerf_tpu_torch.core import cameras, pose_math, sampling
from nerf_and_dietnerf_tpu_torch.models import nerf, vit
from nerf_and_dietnerf_tpu_torch.models.nerf import NeRFConfig
from nerf_and_dietnerf_tpu_torch.train import train_step as ts
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves, tree_map

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DietConfig:
    """Consistency-loss hyperparameters (reference ``src/DietNeRF.py:26-36``)."""

    interval: int = 13
    weight: float = 0.1
    active_fraction: float = 0.95
    cs_image_size: int = 150
    cs_samples: int = 55          # coarse == fine count for the cs render
    cs_chunk_rays: int = 2500     # checkpoint chunk of the differentiable render
    vit: vit.ViTConfig = vit.ViTConfig()


# --------------------------------------------------------------------------- #
# Differentiable low-res render (inside the loss)                              #
# --------------------------------------------------------------------------- #

def render_image_differentiable(params: Params, config: NeRFConfig, diet: DietConfig, key,
                                c2w, field_of_view) -> torch.Tensor:
    """Full-frame ``(size, size, 3)`` render used inside the consistency loss,
    on the parameters' device: the render path (fine z = merged sort) at
    ``cs_image_size`` px with ``cs_samples`` coarse + fine, in chunks of
    ``cs_chunk_rays`` (the ray list padded with copies of the last ray), each
    under ``torch.utils.checkpoint``.

    :param key: ``torch.Generator`` on that device, or None for the
        deterministic mode (mid-bin stratification, even quantiles).
    """
    dev = tree_leaves(params)[0].device
    size, n = diet.cs_image_size, diet.cs_samples
    orig, dirs = cameras.rays_for_image(
        size, size, field_of_view, torch.as_tensor(c2w, dtype=torch.float32, device=dev))
    n_rays = size * size
    chunk = diet.cs_chunk_rays
    n_chunks = -(-n_rays // chunk)
    pad = n_chunks * chunk - n_rays
    if pad:
        orig = torch.cat([orig, orig[-1:].expand(pad, 4)], dim=0)
        dirs = torch.cat([dirs, dirs[-1:].expand(pad, 4)], dim=0)

    def render_chunk(o, d, strat_u, fine_u):
        draws = None if strat_u is None else {"strat_u": strat_u, "fine_u": fine_u}
        result, _ = nerf.render(params, config, None, o, d, n_samples_coarse=n,
                                n_samples_fine=n, diagnostics=False, draws=draws)
        return result.rgb

    parts = []
    for i in range(n_chunks):
        strat_u = fine_u = None
        if key is not None:  # what nerf.render would draw for the chunk, in its order
            strat_u = torch.rand((chunk, n), generator=key, device=dev)
            fine_u = sampling.sorted_uniforms(key, (chunk,), n, device=dev)
        rows = slice(i * chunk, (i + 1) * chunk)
        parts.append(checkpoint.checkpoint(render_chunk, orig[rows], dirs[rows], strat_u,
                                           fine_u, use_reentrant=False))
    return torch.cat(parts, dim=0)[:n_rays].reshape(size, size, 3)


def consistency_loss(params: Params, vit_params: Params, config: NeRFConfig, diet: DietConfig,
                     key, c2w, field_of_view, target_embedding) -> Tuple[torch.Tensor,
                                                                         torch.Tensor]:
    """``weight * (1 - cos(render_emb, target_emb)) / 2`` and the cosine.

    Gradients flow through the render into both MLPs; the embedder is frozen
    (its parameters are detached) and runs in its default bf16, as in the
    JAX package, whatever the NeRF's compute type.
    """
    image = render_image_differentiable(params, config, diet, key, c2w, field_of_view)
    emb = vit.extract_features(tree_map(torch.Tensor.detach, vit_params),
                               vit.preprocess(image, diet.vit), diet.vit)[0]
    target = torch.as_tensor(target_embedding, dtype=torch.float32, device=emb.device)
    cos = torch.sum(emb * target) / (torch.linalg.norm(emb) * torch.linalg.norm(target) + 1e-8)
    return diet.weight * (1.0 - cos) / 2.0, cos


# --------------------------------------------------------------------------- #
# Pose sampling (host side, seeded)                                            #
# --------------------------------------------------------------------------- #

class PoseSampler:
    """Random novel-pose source for the consistency render
    (reference ``src/DietNeRF.py:238-259``, wiring ``src/ExecutionRun.py:250-256``).
    """

    def __init__(self, camera_poses: np.ndarray, point_of_interest: Optional[np.ndarray],
                 front_rotation: Optional[np.ndarray], seed: int = 0):
        self.camera_poses = np.asarray(camera_poses)
        self.point_of_interest = point_of_interest
        self.front_rotation = front_rotation
        self.is_spherical = point_of_interest is not None
        self.rng = np.random.default_rng(seed)

    @classmethod
    def from_dataset(cls, camera_poses: np.ndarray, test_img_idx: int, seed: int = 0):
        """Reference wiring: RANSAC the scene point of interest; if the scene
        is spherical, aim the sampled sphere cameras using the *test* camera's
        rotation (``src/ExecutionRun.py:250-256``)."""
        poi, is_spherical = pose_math.estimate_point_of_interest(camera_poses)
        front = None
        if is_spherical:
            front = np.eye(4)
            front[:3, :3] = camera_poses[test_img_idx][:3, :3]
        return cls(camera_poses, poi if is_spherical else None, front, seed)

    def sample(self) -> np.ndarray:
        if self.is_spherical:
            radius = self.rng.uniform(0.7, 1.1)
            x_rot = self.rng.uniform(-90.0, 0.0)
            y_rot = self.rng.uniform(-180.0, 180.0)
            c2w = pose_math.sphere_c2w(radius, x_rot, y_rot, 0.0)
            c2w = self.front_rotation @ c2w
            c2w[:3, 3] += self.point_of_interest
            return c2w
        picks = self.rng.choice(len(self.camera_poses), 3, replace=False)
        a = self.rng.uniform(0.0, 1.0, 2)
        p1 = pose_math.interpolate_c2w(
            self.camera_poses[picks[0]], self.camera_poses[picks[1]], a[0])
        return pose_math.interpolate_c2w(p1, self.camera_poses[picks[2]], a[1])


# --------------------------------------------------------------------------- #
# Train steps                                                                  #
# --------------------------------------------------------------------------- #

def diet_train_step(state: ts.TrainState, key, batch, c2w, target_embedding, vit_params, *,
                    config: NeRFConfig, diet: DietConfig, optimizer: ts.Adam,
                    field_of_view: float, mesh=None
                    ) -> Tuple[ts.TrainState, Dict[str, torch.Tensor]]:
    """The every-K-th step: ray loss + consistency loss, then Adam. ``key``
    (a ``torch.Generator``) gives the ray loss's draws, then the consistency
    render's. Metrics have the reference's names (``src/DietNeRF.py:174-190``):
    ``loss``, ``loss_for_rays``, ``cosine_similarity_loss``, ``psnr_coarse``,
    ``psnr_fine``.

    With ``mesh`` the ray loss is a rank's, as in ``train_step.train_step``,
    and the consistency term (render, ViT, cosine) is computed whole and
    alike on every rank from the same draws: added to each rank's ray loss
    before the gradient's mean over the ranks, it gives the single-device
    gradient (the mean of equal terms is the term)."""
    orig, dirs, rgb = batch
    draws = None
    if mesh is not None:
        draws = ts.group_draws(key, config, mesh, orig.shape[0],
                               state.params.get("fine") is not None, orig.device)

    def loss_fn(params):
        if mesh is None:
            ray_loss, metrics = nerf.training_losses(params, config, key, orig, dirs, rgb)
        else:  # the MSEs, averaged with the gradient before the PSNRs are taken
            ray_loss, metrics = nerf.training_mses(params, config, key, orig, dirs, rgb,
                                                   draws=draws)
        cs_loss, _ = consistency_loss(params, vit_params, config, diet, key, c2w,
                                      field_of_view, target_embedding)
        loss = ray_loss + cs_loss
        return loss, dict(metrics, loss_for_rays=ray_loss.detach(),
                          cosine_similarity_loss=cs_loss.detach(), loss=loss.detach())

    _, metrics, grads = ts.loss_and_grads(state.params, loss_fn)
    if mesh is not None:
        grads, scalars = ts.reduce_over_group(grads, metrics, mesh)
        extra = {k: scalars.pop(k) for k in ("loss_for_rays", "cosine_similarity_loss")}
        metrics = dict(nerf.metrics_of(scalars.pop("loss"), scalars), **extra)
    updates, opt_state = optimizer.update(grads, state.opt_state)
    return ts.TrainState(ts.apply_updates(state.params, updates), opt_state,
                         state.step + 1), metrics


def consistency_steps_budget(n_batches_per_epoch: int, n_epochs: int, start_epoch: int,
                             diet: DietConfig) -> int:
    """Number of initial steps for which the loss stays active
    (reference ``src/ExecutionRun.py:245-247``)."""
    total = n_batches_per_epoch * (n_epochs - start_epoch)
    return int(total * diet.active_fraction)


def is_diet_step(step: int, diet: DietConfig, budget: int) -> bool:
    """Whether the step after ``step`` steps takes the consistency loss: the
    reference increments its counter first and gates on
    ``counter % interval == 0 and counter < budget`` (``src/DietNeRF.py:224-236``)."""
    counter = step + 1
    return counter % diet.interval == 0 and counter < budget


def make_diet_epoch_fn(config: NeRFConfig, diet: DietConfig, optimizer: ts.Adam,
                       field_of_view: float, n_batches: int, batch_size: int, budget: int,
                       mesh=None):
    """One DietNeRF epoch over a ray table on the device: the plain epoch of
    ``train_step.make_epoch_fn`` with the diet step at the positions
    :func:`is_diet_step` picks (with ``mesh``, both steps on this rank's rows
    of every batch).

    Returned callable::

        epoch_fn(state, key, origins, dirs, rgb, c2ws, targets, vit_params)
            -> (state, mean_metrics)

    with ``c2ws (n_batches, 4, 4)`` / ``targets (n_batches, emb_dim)``: the
    host-presampled novel poses and target embeddings, read only at the diet
    positions. Plain steps report ``loss_for_rays = loss`` and a zero
    ``cosine_similarity_loss``, as in the JAX package.
    """
    if mesh is not None:
        config = dataclasses.replace(config, mesh=mesh)

    def epoch_fn(state, key, origins, dirs, rgb, c2ws, targets, vit_params):
        def step(state, batch, i):
            if is_diet_step(state.step, diet, budget):
                return diet_train_step(state, key, batch, c2ws[i], targets[i], vit_params,
                                       config=config, diet=diet, optimizer=optimizer,
                                       field_of_view=field_of_view, mesh=mesh)
            state, metrics = ts.train_step(state, key, batch, config=config, optimizer=optimizer,
                                           mesh=mesh)
            return state, dict(metrics, loss_for_rays=metrics["loss"],
                               cosine_similarity_loss=torch.zeros_like(metrics["loss"]))

        return ts.run_epoch(state, key, (origins, dirs, rgb), n_batches, batch_size, step, mesh)

    return epoch_fn
