"""Training ray table: every training pixel as an (origin, direction, rgb) row.

Port of ``nerf_and_dietnerf_tpu/data/pipeline.py``. The rays come from the
port's own camera code; the trainer keeps the table on the device and draws
a fresh permutation per epoch (``train/train_step.make_epoch_fn``). Epoch
size is ``(n_images * h * w) // batch`` steps, remainder rays dropped.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nerf_and_dietnerf_tpu_torch.core import cameras


def build_ray_table(images: np.ndarray, c2w_matrices: np.ndarray, field_of_view: float
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(origins (N,4), directions (N,4), rgb (N,3))`` float32 numpy arrays,
    ``N = n_images * h * w``."""
    n, h, w = images.shape[:3]
    origins, dirs = [], []
    for c2w in np.asarray(c2w_matrices, np.float32):
        o, d = cameras.rays_for_image(h, w, field_of_view, torch.from_numpy(c2w))
        origins.append(o.numpy())
        dirs.append(d.numpy())
    origins = np.concatenate(origins).reshape(-1, 4).astype(np.float32)
    dirs = np.concatenate(dirs).reshape(-1, 4).astype(np.float32)
    rgb = np.ascontiguousarray(images.reshape(-1, 3), dtype=np.float32)
    return origins, dirs, rgb


class RayDataset:
    """The training split's ray table; the trainer keeps it on the device and
    batches it there (``train/train_step.make_epoch_fn``)."""

    def __init__(self, images: np.ndarray, c2w_matrices: np.ndarray, field_of_view: float,
                 batch_size: int):
        self.origins, self.directions, self.rgb = build_ray_table(
            images, c2w_matrices, field_of_view)
        self.batch_size = batch_size
        self.n_rays = self.rgb.shape[0]
        self.batches_per_epoch = self.n_rays // batch_size
