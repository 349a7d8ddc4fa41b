"""Camera / ray generation math.

Port of ``nerf_and_dietnerf_tpu/core/cameras.py``, same conventions:

- pixel centres at ``+0.5``, raster -> screen scaled by ``tan(fov/2)``, the
  camera looks down ``-z``;
- directions are homogeneous 4-vectors (``w = 0``) rotated by the c2w matrix
  and **not normalized**;
- origins are the c2w translation column broadcast per pixel;
- view features are components ``[0, 2]`` (1 angle) or ``[0, 1, 2]`` (2).
"""

from __future__ import annotations

import torch


def ray_directions(height: int, width: int, field_of_view, c2w) -> torch.Tensor:
    """``(height, width, 4)`` unnormalized world-space directions (w = 0).

    The rotation is an explicit f32 multiply-and-sum, so it is full f32 on
    every device whatever the TF32 settings (the JAX package asks for
    HIGHEST precision here).
    """
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    dev = c2w.device
    fov = torch.as_tensor(field_of_view, dtype=torch.float32, device=dev)
    x = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    y = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height
    x_screen = 2.0 * x - 1.0
    y_screen = 1.0 - 2.0 * y
    tan_half_fov = torch.tan(fov / 2.0)
    xs = (x_screen[None, :] * tan_half_fov).expand(height, width)
    ys = (y_screen[:, None] * tan_half_fov).expand(height, width)
    dirs_cam = torch.stack(
        [xs, ys, -torch.ones_like(xs), torch.zeros_like(xs)], dim=-1
    )  # (h, w, 4)
    return (c2w[None, None, :, :] * dirs_cam[:, :, None, :]).sum(-1)


def rays_for_image(height: int, width: int, field_of_view, c2w):
    """``(origins, directions)``, both ``(height * width, 4)``."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    dirs = ray_directions(height, width, field_of_view, c2w).reshape(-1, 4)
    origins = c2w[:, 3].expand(dirs.shape)
    return origins, dirs


def sample_points_along_rays(origins, directions, z_values) -> torch.Tensor:
    """``o + z * d``: ``(..., n_samples, dim)``."""
    return origins[..., None, :] + directions[..., None, :] * z_values[..., None]


def view_direction_components(directions, n_angles: int) -> torch.Tensor:
    """``(rays, n_angles + 1)`` direction components for the view branch."""
    if n_angles == 1:
        idx = [0, 2]
    elif n_angles == 2:
        idx = [0, 1, 2]
    else:
        raise ValueError("n_angles must be 1 or 2")
    return directions[..., idx]
