"""DietNeRF training: the Trainer plus the every-K-th-step diet step.

Port of ``nerf_and_dietnerf_tpu/train/diet_trainer.py`` (reference
``src/DietNeRF.py:120-157, :224-236``): a step counter gates the consistency
loss, active when ``counter % 13 == 0`` and ``counter < 0.95 * total_steps``.
The JAX package has two epoch paths (a per-step dispatch and an on-device
``lax.scan``); the port has one, the ``Trainer``'s epoch over the ray table on
the device, whose loop picks the diet step on the host
(``dietnerf.make_diet_epoch_fn``). The novel poses and target embeddings of
an epoch are drawn before it, from the JAX package's numpy streams, so they
are that package's poses and picks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from nerf_and_dietnerf_tpu_torch.models import dietnerf, vit
from nerf_and_dietnerf_tpu_torch.models.dietnerf import DietConfig, PoseSampler
from nerf_and_dietnerf_tpu_torch.train.trainer import Trainer
from nerf_and_dietnerf_tpu_torch.utils.config import RunConfig


def check_embedder(run: RunConfig, vit_weights: Optional[str]) -> None:
    """Refuse a DietNeRF run with neither ViT weights nor the explicit opt-in
    to the random embedder."""
    if not vit_weights and not run.allow_random_embedder:
        # Hard failure, not a warning: the random-init embedder measurably
        # loses quality (-1.83 dB test PSNR vs turning the consistency loss
        # off, 50px few-shot A/B in runs/diet_ab_50px/RESULTS.md), so a stock
        # dietnerf YAML must not silently train a worse-than-NeRF model.
        raise ValueError(
            "DietNeRF needs pretrained ViT weights for its semantic "
            "consistency loss. Without them the embedder is random and "
            "the consistency loss COSTS quality (measured -1.83 dB vs "
            "consistency-off, runs/diet_ab_50px/RESULTS.md). Pass "
            "--vit-weights <ViT-B/32 checkpoint>, or set "
            "`allow_random_embedder: true` in the YAML to run the "
            "degraded non-semantic mode anyway."
        )


class DietTrainer(Trainer):
    """Trainer with semantic-consistency regularization.

    :param vit_weights: optional path to ViT weights (``models/vit.py``
        ``load_pretrained`` formats); an ``.npz`` that embeds its geometry
        sets ``diet.vit``. Without weights the run needs
        ``allow_random_embedder: true`` and draws a random embedder
        (non-semantic; a warning is printed).
    """

    trains_dietnerf = True

    def __init__(self, run: RunConfig, dataset, save_dir, device=None, epoch_callback=None,
                 diet: DietConfig = DietConfig(), vit_weights: Optional[str] = None, mesh=None):
        check_embedder(run, vit_weights)
        super().__init__(run, dataset, save_dir, device=device, epoch_callback=epoch_callback,
                         mesh=mesh)
        if vit_weights:
            # A checkpoint written by vit.save_npz may carry its own geometry
            # (a small scene-trained embedder, say); adopt it, and say so.
            inferred = vit.infer_config(vit_weights)
            if inferred is not None and inferred != diet.vit:
                print(f"[dietnerf] {vit_weights} embeds the ViT geometry {inferred}; it "
                      f"replaces {diet.vit}")
                diet = dataclasses.replace(diet, vit=inferred)
            self.vit_params = vit.load_pretrained(vit_weights, diet.vit, device=self.device)
        else:
            print(
                "[dietnerf] WARNING: allow_random_embedder=true — the "
                "consistency embedder is randomly initialized (non-semantic; "
                "measured -1.83 dB vs consistency-off). Pass "
                "vit_weights=<path> for DietNeRF-paper behavior."
            )
            self.vit_params = vit.init_params(torch.Generator().manual_seed(7), diet.vit,
                                              device=self.device)
        self.diet = diet
        self.target_embeddings = self._embed_training_images()
        self.pose_sampler = PoseSampler.from_dataset(
            dataset.camera_poses[self.train_indices], run.test_img_idx)
        self._embedding_rng = np.random.default_rng(11)
        self.consistency_budget = dietnerf.consistency_steps_budget(
            self.data.batches_per_epoch, run.n_epochs, self.start_epoch, diet)

    @torch.no_grad()
    def _embed_training_images(self) -> torch.Tensor:
        """``(n_train, hidden)`` embeddings of the training images, computed
        once on the device (reference ctor, ``src/DietNeRF.py:84``)."""
        images = torch.as_tensor(self.dataset.images[self.train_indices], device=self.device)
        return vit.extract_features(self.vit_params, vit.preprocess(images, self.diet.vit),
                                    self.diet.vit)

    def _presample_diet_inputs(self):
        """The epoch's novel poses ``(n, 4, 4)`` and target embeddings
        ``(n, hidden)`` on the device, drawn on the host at exactly the diet
        positions (the samplers advance only on diet steps, as in the JAX
        package); zeros elsewhere. The host streams are seeded alike on every
        rank of a group, so every rank draws the same."""
        n = self.data.batches_per_epoch
        c2ws = np.zeros((n, 4, 4), np.float32)
        rows, picks = [], []
        for i in range(n):
            if dietnerf.is_diet_step(self.state.step + i, self.diet, self.consistency_budget):
                c2ws[i] = self.pose_sampler.sample()
                rows.append(i)
                picks.append(int(self._embedding_rng.integers(len(self.target_embeddings))))
        targets = torch.zeros((n, self.target_embeddings.shape[-1]), device=self.device)
        targets[torch.tensor(rows, dtype=torch.long, device=self.device)] = \
            self.target_embeddings[torch.tensor(picks, dtype=torch.long, device=self.device)]
        return torch.as_tensor(c2ws, device=self.device), targets

    def _make_epoch_fn(self):
        diet_epoch = dietnerf.make_diet_epoch_fn(
            self.config, self.diet, self.optimizer, self.dataset.field_of_view,
            self.data.batches_per_epoch, self.run.n_rays_in_batch_train,
            self.consistency_budget, mesh=self.mesh)

        def epoch_fn(state, key, origins, dirs, rgb):
            c2ws, targets = self._presample_diet_inputs()
            return diet_epoch(state, key, origins, dirs, rgb, c2ws, targets, self.vit_params)

        return epoch_fn
