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
from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib


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
    """The training split's ray table; the trainer keeps it whole on the
    device and batches it there (``train/train_step.make_epoch_fn``).

    :param process_index / process_count: this rank's slice of each global
        batch, as in the JAX package: every rank draws the same permutation
        and takes rows ``[rank * per_host, (rank + 1) * per_host)`` of every
        batch (``parallel.mesh.batch_indices``, which the epoch loop runs).
    """

    def __init__(self, images: np.ndarray, c2w_matrices: np.ndarray, field_of_view: float,
                 batch_size: int, process_index: int = 0, process_count: int = 1):
        lo, hi = mesh_lib.batch_rows(batch_size, process_index, process_count)
        self.origins, self.directions, self.rgb = build_ray_table(
            images, c2w_matrices, field_of_view)
        self.batch_size = batch_size
        self.per_host = hi - lo
        self.process_index = process_index
        self.process_count = process_count
        self.n_rays = self.rgb.shape[0]
        self.batches_per_epoch = self.n_rays // batch_size

    def batch_indices(self, perm, b: int):
        """This rank's rows of batch ``b`` of the permutation ``perm``."""
        return mesh_lib.batch_indices(perm, b, self.batch_size, self.process_index,
                                      self.process_count)
