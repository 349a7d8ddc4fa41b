"""Volume rendering: alpha compositing along the per-ray sample axis.

Port of ``nerf_and_dietnerf_tpu/core/rendering.py``, same contract:
``sigma = relu(raw[..., 3] (+ noise))``, ``rgb = sigmoid(raw[..., :3])``,
``delta_i = z_{i+1} - z_i`` with a ``1e9`` terminal delta and no scaling by
the direction norm, ``alpha = 1 - exp(-sigma * delta)``, transmittance the
exclusive cumprod of ``1 - alpha``, pixel ``sum(weights * rgb)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

TERMINAL_DELTA = 1e9


class RenderResult(NamedTuple):
    rgb: torch.Tensor                     # (..., 3)
    weights: torch.Tensor                 # (..., S)
    cumprod: Optional[torch.Tensor]       # (..., S) exclusive transmittance
    alpha: Optional[torch.Tensor]         # (..., S)
    sample_rgb: Optional[torch.Tensor]    # (..., S, 3)


def composite(raw: torch.Tensor, z_values: torch.Tensor, sigma_noise=None) -> RenderResult:
    """Alpha-composite raw MLP outputs ``(..., S, 4)`` along the sample axis.

    ``torch.sigmoid`` differentiates as ``s * (1 - s)``, which stays finite at
    logits <= -89 where the naive ``1 / (1 + exp(-x))`` gives ``0 * inf``.
    """
    raw = raw.float()
    z_values = z_values.float()
    sigma_preact = raw[..., 3]
    if sigma_noise is not None:
        sigma_preact = sigma_preact + sigma_noise
    sigma = torch.clamp_min(sigma_preact, 0.0)
    sample_rgb = torch.sigmoid(raw[..., :3])

    delta = torch.diff(z_values, dim=-1)
    delta = torch.cat(
        [delta, torch.full((*delta.shape[:-1], 1), TERMINAL_DELTA, dtype=delta.dtype,
                           device=delta.device)],
        dim=-1,
    )
    alpha = 1.0 - torch.exp(-sigma * delta)
    transmittance = exclusive_cumprod(1.0 - alpha)
    weights = alpha * transmittance
    rgb = torch.sum(weights[..., None] * sample_rgb, dim=-2)
    return RenderResult(rgb, weights, transmittance, alpha, sample_rgb)


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """``[1, x0, x0*x1, ...]`` along the last axis."""
    ones = torch.ones((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
    return torch.cat([ones, torch.cumprod(x[..., :-1], dim=-1)], dim=-1)


def psnr_from_mse(mse):
    """PSNR in dB for signals with peak value 1."""
    mse = torch.as_tensor(mse)
    return -10.0 * torch.log(mse) / math.log(10.0)


def psnr(image_a, image_b):
    return psnr_from_mse(torch.mean(torch.square(image_a - image_b)))
