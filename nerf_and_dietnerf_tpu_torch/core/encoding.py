"""Positional (Fourier) encodings for positions and view directions.

Port of ``nerf_and_dietnerf_tpu/core/encoding.py``; the feature layout is the
same (it is what imported weights expect):

- xyz: per coordinate ``[c, sin(pi c), cos(pi c), sin(2 pi c), ...]``,
  coordinate-major (all of x's features, then y's, then z's);
  ``3 + 3 * 2 * L`` wide, identity when ``L == 0``.
- view dirs: the same interleave without the identity term,
  ``D * 2 * L`` wide.
"""

from __future__ import annotations

import math

import torch


def _sin_cos_features(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """``(..., D) -> (..., D, 2 * n_freqs)``: [sin f0, cos f0, sin f1, ...].

    sin/cos at the base frequency, then the double-angle recurrences
    ``sin 2t = 2 sin t cos t``, ``cos 2t = 1 - 2 sin^2 t``, exactly as the JAX
    package computes them (direct ``sin(2^k pi x)`` rounds differently).
    """
    theta0 = x * math.pi
    sin_k = torch.sin(theta0)
    cos_k = torch.cos(theta0)
    feats = [sin_k, cos_k]
    for _ in range(n_freqs - 1):
        sin_k, cos_k = 2.0 * sin_k * cos_k, 1.0 - 2.0 * sin_k * sin_k
        feats += [sin_k, cos_k]
    return torch.stack(feats, dim=-1)


def encode_xyz(xyz: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """``(..., 3) -> (..., 3 + 3 * 2 * L)`` (identity when ``L == 0``)."""
    if n_freqs == 0:
        return xyz
    per_coord = torch.cat([xyz[..., None], _sin_cos_features(xyz, n_freqs)], dim=-1)
    return per_coord.reshape(*xyz.shape[:-1], 3 * (1 + 2 * n_freqs))


def encode_view_dirs(dirs: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """``(..., D) -> (..., D * 2 * L)``, sin/cos only."""
    d = dirs.shape[-1]
    return _sin_cos_features(dirs, n_freqs).reshape(*dirs.shape[:-1], d * 2 * n_freqs)


def xyz_encoding_dim(n_freqs: int) -> int:
    return 3 + 3 * 2 * n_freqs


def view_encoding_dim(n_freqs: int, n_angles: int) -> int:
    return n_freqs * 2 * (n_angles + 1)
