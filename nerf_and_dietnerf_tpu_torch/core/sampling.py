"""Stratified and hierarchical (inverse-CDF) z sampling.

Port of ``nerf_and_dietnerf_tpu/core/sampling.py``. Randomness comes from an
explicit ``torch.Generator`` (``key``); ``key=None`` is the deterministic
mode of the JAX package (mid-bin offsets, evenly spaced quantiles). Each
sampler also takes its random numbers injected (``uniform=``,
``u=``), so a test can feed both packages the same draws.

The TPU package expressed gathers and the sorted merge as one-hot matmuls.
Here the bin search is ``searchsorted`` and the merge a stable ``sort``; the
row-wise picks of the resampling are gathers whose backward is the
reference's one-hot product (:class:`_Pick`), because the backward of
``torch.gather`` is a ``scatter_add_`` that adds with atomics on the GPU, so a
training step would not be bitwise reproducible.
"""

from __future__ import annotations

from typing import Optional

import torch

CDF_EPS = 1e-7       # pdf normalization epsilon
DENOM_CLAMP = 1e-5   # cdf-range denominator clamp


def stratified_z_values(key, near, far, batch_shape, n_samples: int, *, device=None,
                        uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(*batch_shape, n_samples)`` z: ``linspace(near, far)`` plus a jitter of
    up to one bin. ``key`` is a ``torch.Generator`` (on ``device``) or None for
    the fixed mid-bin offsets; ``uniform`` injects the U(0,1) draws."""
    if uniform is not None:
        device = uniform.device
    near_t = torch.tensor(near, dtype=torch.float32, device=device)
    far_t = torch.tensor(far, dtype=torch.float32, device=device)
    base = torch.linspace(float(near), float(far), n_samples, dtype=torch.float32,
                          device=device)
    shape = (*tuple(batch_shape), n_samples)
    if uniform is None and key is None:
        return (base + 0.5 * (far_t - near_t) / n_samples).expand(shape)
    if uniform is None:
        uniform = torch.rand(shape, generator=key, device=device)
    return base + uniform * ((far_t - near_t) / n_samples)


def sorted_uniforms(key, batch_shape, n: int, *, device=None) -> torch.Tensor:
    """``n`` ascending U(0,1) order statistics per row: normalized partial sums
    of ``n + 1`` Exp(1) draws. ``key=None``: quantiles ``(i + 0.5) / n``."""
    if key is None:
        u = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n
        return u.expand(*tuple(batch_shape), n)
    e = torch.empty((*tuple(batch_shape), n + 1), dtype=torch.float32, device=device)
    e.exponential_(generator=key)
    return torch.cumsum(e[..., :-1], dim=-1) / torch.sum(e, dim=-1, keepdim=True)


class _Pick(torch.autograd.Function):
    """``values[..., idx]`` along the last axis. The forward is a gather; the
    backward is the reference's one-hot product transposed (a batched matrix
    product of the 0/1 matrix ``idx == column`` with the cotangent), not the
    gather's ``scatter_add_``, which adds with atomics on the GPU. The
    product runs in full f32 even where the caller allowed TF32, which would
    round the cotangents to 10-bit mantissas."""

    @staticmethod
    def forward(ctx, idx, values):
        ctx.save_for_backward(idx)
        ctx.width = values.shape[-1]
        return torch.gather(values, -1, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        hit = idx.unsqueeze(-2) == torch.arange(ctx.width, device=idx.device).unsqueeze(-1)
        flags = torch.backends.cuda.matmul
        allow_tf32 = flags.allow_tf32
        flags.allow_tf32 = False
        try:
            return None, torch.matmul(hit.to(g.dtype), g.unsqueeze(-1)).squeeze(-1)
        finally:
            flags.allow_tf32 = allow_tf32


_pick = _Pick.apply


def resample_z_from_weights(key, weights, z_values, n_new: int, *,
                            u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw ``n_new`` sorted z from the coarse weight PDF (inverse CDF with
    linear interpolation between bin midpoints). Differentiable in both
    ``weights`` and ``z_values``. ``u`` injects the sorted uniforms."""
    weights = weights.float()
    z_values = z_values.float()
    n_coarse = weights.shape[-1]

    pdf = weights / (torch.sum(weights, dim=-1, keepdim=True) + CDF_EPS)
    cdf = torch.cumsum(pdf, dim=-1)
    if u is None:
        u = sorted_uniforms(key, weights.shape[:-1], n_new, device=weights.device)
    u = u.expand(*weights.shape[:-1], n_new).contiguous()

    # Left bisect: idx = #{j : cdf[j] < u}.
    idx = torch.searchsorted(cdf.detach().contiguous(), u, side="left")
    lo = torch.clamp_min(idx - 1, 0)
    hi = torch.clamp_max(idx, n_coarse - 1)
    cdf_lo = _pick(lo, cdf)
    cdf_hi = _pick(hi, cdf)

    z_mid = 0.5 * (z_values[..., 1:] + z_values[..., :-1])
    z_lo = _pick(torch.clamp(lo, 0, n_coarse - 2), z_mid)
    z_hi = _pick(torch.clamp(hi, 0, n_coarse - 2), z_mid)

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < DENOM_CLAMP, torch.full_like(denom, DENOM_CLAMP), denom)
    t = (u - cdf_lo) / denom
    return z_lo + t * (z_hi - z_lo)


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two per-row sorted arrays. A stable sort of ``[a, b]`` puts
    ``a_i`` before an equal ``b_j``: the JAX package's ``<`` / ``<=`` rank
    rule."""
    merged, _ = torch.sort(torch.cat([a, b], dim=-1), dim=-1, stable=True)
    return merged


def merged_fine_z_values(key, weights, z_coarse, n_fine: int, *,
                         u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Render-path fine z: the resampled z merged with the coarse z."""
    z_new = resample_z_from_weights(key, weights, z_coarse, n_fine, u=u)
    return merge_sorted(z_new, z_coarse)
