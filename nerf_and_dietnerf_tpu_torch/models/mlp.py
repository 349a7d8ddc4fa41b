"""The NeRF radiance-field MLP family, as nested dicts of tensors.

Port of ``nerf_and_dietnerf_tpu/models/mlp.py``, with the same parameter
layout (``{"trunk": [{"kernel", "bias"} x 8], "rgb_hidden", "rgb_out",
"sigma_out"}`` plus ``"rgb_hidden0"`` in the xyz-only variant), kernels
stored ``(fan_in, fan_out)``:

- **xyz-only** (``n_angles == 0``): 8 leaky dense layers with the encoded
  input re-joined before layer 4; sigma = Dense(1)(h8); rgb =
  Dense(hidden) -> Dense(last_hidden) -> Dense(3).
- **xyz + view dirs**: the same trunk; ``feat = (h8 | enc_dir)``;
  rgb = Dense(last_hidden)(feat) -> Dense(3); sigma = Dense(1)(feat) (sigma
  sees the view encoding: the reference architecture's quirk, kept for
  weight compatibility).

Every ``concat([a, b]) @ W`` is computed as ``a @ W[:dim_a] + b @ W[dim_a:]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from nerf_and_dietnerf_tpu_torch.core import encoding
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves, tree_map

Params = Dict[str, Any]

N_TRUNK_LAYERS = 8
SKIP_AFTER = 4  # encoded input re-joins the trunk before this layer


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """Architecture hyperparameters (YAML ``neural_net`` section)."""

    hidden_dim: int = 256
    last_hidden_dim: int = 128
    leaky_relu_alpha: float = 0.05
    n_freq_xyz: int = 5
    n_freq_dir: int = 4
    n_angles: int = 2
    sigma_bias_init: float = 0.0

    @property
    def xyz_dim(self) -> int:
        return encoding.xyz_encoding_dim(self.n_freq_xyz)

    @property
    def dir_dim(self) -> int:
        return encoding.view_encoding_dim(self.n_freq_dir, self.n_angles)

    @property
    def uses_view_dirs(self) -> bool:
        return self.n_angles > 0


def _glorot(generator, shape):
    """Glorot-uniform (the Keras Dense default)."""
    fan_in, fan_out = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(-limit, limit, generator=generator)


def _dense_params(generator, d_in: int, d_out: int) -> Params:
    return {"kernel": _glorot(generator, (d_in, d_out)),
            "bias": torch.zeros((d_out,), dtype=torch.float32)}


def init_params(generator: torch.Generator, config: MLPConfig, device="cpu") -> Params:
    """One radiance MLP, drawn from a CPU ``generator``, placed on ``device``."""
    h = config.hidden_dim
    xyz = config.xyz_dim
    trunk = []
    d_in = xyz
    for layer in range(N_TRUNK_LAYERS):
        if layer == SKIP_AFTER:
            d_in = xyz + h
        trunk.append(_dense_params(generator, d_in, h))
        d_in = h
    params: Params = {"trunk": trunk}
    if config.uses_view_dirs:
        feat = h + config.dir_dim
        params["rgb_hidden"] = _dense_params(generator, feat, config.last_hidden_dim)
        params["rgb_out"] = _dense_params(generator, config.last_hidden_dim, 3)
        params["sigma_out"] = _dense_params(generator, feat, 1)
    else:
        params["rgb_hidden0"] = _dense_params(generator, h, h)
        params["rgb_hidden"] = _dense_params(generator, h, config.last_hidden_dim)
        params["rgb_out"] = _dense_params(generator, config.last_hidden_dim, 3)
        params["sigma_out"] = _dense_params(generator, h, 1)
    if config.sigma_bias_init:
        params["sigma_out"]["bias"] = torch.full((1,), config.sigma_bias_init,
                                                 dtype=torch.float32)
    return tree_map(lambda t: t.to(device), params)


def params_from_jax(tree, device="cpu"):
    """JAX parameter pytree (numpy or jax arrays, any nesting of dicts, lists
    and None) -> the port's tree of f32 tensors on ``device``. The one place
    weights cross from the JAX package to the port."""
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=device), tree
    )


def params_to_jax(tree):
    """Inverse of :func:`params_from_jax`: a tree of float32 numpy arrays."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(), tree)


def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held in float32 (identity for f32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def leaky_relu(x, alpha: float):
    return torch.where(x >= 0, x, alpha * x)


def _dense(p: Params, x, dtype):
    return x @ round_to(p["kernel"], dtype) + p["bias"]


def _split_dense(p: Params, a, b, dim_a: int, dtype):
    w = round_to(p["kernel"], dtype)
    return a @ w[:dim_a] + b @ w[dim_a:] + p["bias"]


def apply_mlp(params: Params, config: MLPConfig, enc_xyz: torch.Tensor,
              enc_dir: torch.Tensor | None = None,
              compute_dtype=torch.float32) -> torch.Tensor:
    """The MLP in plain torch ops: ``(n, 4)`` float32 raw ``[rgb, sigma]``.

    ``compute_dtype`` is the matmul operand type: operands are rounded to it
    and multiplied in f32 (exact products, f32 sums), the semantics of
    ``preferred_element_type=float32`` in the JAX package. Autograd through
    the roundings rounds the cotangents as JAX's transpose of ``astype`` does.
    """
    alpha = config.leaky_relu_alpha
    cd = compute_dtype
    x = round_to(enc_xyz.float(), cd)
    h = x
    for layer in range(N_TRUNK_LAYERS):
        p = params["trunk"][layer]
        if layer == SKIP_AFTER:
            pre = _split_dense(p, x, round_to(h, cd), config.xyz_dim, cd)
        else:
            pre = _dense(p, round_to(h, cd), cd)
        h = leaky_relu(pre, alpha)

    if config.uses_view_dirs:
        if enc_dir is None:
            raise ValueError("this MLP config requires encoded view directions")
        d = round_to(enc_dir.float(), cd)
        hc = round_to(h, cd)
        rgb_h = leaky_relu(
            _split_dense(params["rgb_hidden"], hc, d, config.hidden_dim, cd), alpha
        )
        rgb = _dense(params["rgb_out"], round_to(rgb_h, cd), cd)
        sigma = _split_dense(params["sigma_out"], hc, d, config.hidden_dim, cd)
    else:
        hc = round_to(h, cd)
        r = leaky_relu(_dense(params["rgb_hidden0"], hc, cd), alpha)
        r = leaky_relu(_dense(params["rgb_hidden"], round_to(r, cd), cd), alpha)
        rgb = _dense(params["rgb_out"], round_to(r, cd), cd)
        sigma = _dense(params["sigma_out"], hc, cd)
    return torch.cat([rgb, sigma], dim=-1).float()


def count_params(params: Params) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))
