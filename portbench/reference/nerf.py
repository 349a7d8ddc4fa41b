"""Plain NeRF in PyTorch: the reference the benchmark holds the port against.

NeRF as in Mildenhall et al. (arXiv:2003.08934), with the conventions of the
reference implementation's configs (Sahar-E/NeRF-and-DietNeRF):

- rays: pixel centres at +0.5, screen scaled by ``tan(fov / 2)``, the camera
  looking down -z; directions not normalized; the view branch reads the
  direction's three components;
- encodings: per coordinate ``[c, sin(pi c), cos(pi c), sin(2 pi c), ...]``,
  the higher frequencies by the double-angle recurrences, coordinate-major;
  the view encoding without the identity term;
- the MLP: 8 leaky layers of ``hidden`` with the encoded input joined again
  before layer 4; ``feat = (h8 | enc_dir)``; rgb = Dense(last)(feat) ->
  Dense(3); sigma = Dense(1)(feat);
- compositing: ``sigma = relu``, ``rgb = sigmoid``, deltas with a 1e9 last
  one, ``alpha = 1 - exp(-sigma delta)``, exclusive transmittance;
- sampling: stratified coarse z, the fine z drawn from the coarse weights by
  the inverse CDF between bin midpoints (training: the drawn z alone;
  rendering: merged with the coarse z).

Each product's operands pass through a rounding (``precision.rounder``), so
one function serves the stated precision and its control. It imports nothing
of the program: it takes weights, rays' poses, images and random draws that
the benchmark made, and works out everything else itself.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

N_TRUNK = 8
SKIP = 4
TERMINAL_DELTA = 1e9
CDF_EPS = 1e-7
DENOM_CLAMP = 1e-5


# --------------------------------------------------------------------------- #
# Rays, encodings, the MLP, compositing                                        #
# --------------------------------------------------------------------------- #

def pixel_rays(c2w: torch.Tensor, height: int, width: int, fov: float, ys: torch.Tensor,
               xs: torch.Tensor):
    """Origins and directions ``(n, 3)`` of the pixels ``(ys, xs)``."""
    dev = c2w.device
    tan = torch.tan(torch.tensor(fov, dtype=torch.float32, device=dev) / 2.0)
    sx = (2.0 * ((xs.float() + 0.5) / width) - 1.0) * tan
    sy = (1.0 - 2.0 * ((ys.float() + 0.5) / height)) * tan
    rot = c2w[:3, :3].float()
    dirs = rot[:, 0] * sx[:, None] + rot[:, 1] * sy[:, None] - rot[:, 2]
    origins = c2w[:3, 3].float().expand(dirs.shape)
    return origins, dirs


def image_rays(c2w: torch.Tensor, height: int, width: int, fov: float):
    """Every pixel's ray of a ``height x width`` frame, row-major."""
    dev = c2w.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev),
                            indexing="ij")
    return pixel_rays(c2w, height, width, fov, ys.reshape(-1), xs.reshape(-1))


def _sin_cos(x: torch.Tensor, n: int) -> torch.Tensor:
    s, c = torch.sin(x * math.pi), torch.cos(x * math.pi)
    feats = [s, c]
    for _ in range(n - 1):
        s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
        feats += [s, c]
    return torch.stack(feats, dim=-1)


def encode_xyz(x: torch.Tensor, n: int) -> torch.Tensor:
    per = torch.cat([x[..., None], _sin_cos(x, n)], dim=-1)
    return per.reshape(*x.shape[:-1], x.shape[-1] * (1 + 2 * n))


def encode_dirs(d: torch.Tensor, n: int) -> torch.Tensor:
    return _sin_cos(d, n).reshape(*d.shape[:-1], d.shape[-1] * 2 * n)


def _leaky(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


def mlp(p: Dict, enc_xyz: torch.Tensor, enc_dir: torch.Tensor, alpha: float, rnd) -> torch.Tensor:
    """Raw ``(n, 4)`` [rgb, sigma] of one network."""
    x = rnd(enc_xyz)
    h = x
    for layer in range(N_TRUNK):
        w, b = p["trunk"][layer]["kernel"], p["trunk"][layer]["bias"]
        inp = torch.cat([x, rnd(h)], dim=-1) if layer == SKIP else rnd(h)
        h = _leaky(inp @ rnd(w) + b, alpha)
    feat = torch.cat([rnd(h), rnd(enc_dir)], dim=-1)
    rgb_h = _leaky(feat @ rnd(p["rgb_hidden"]["kernel"]) + p["rgb_hidden"]["bias"], alpha)
    rgb = rnd(rgb_h) @ rnd(p["rgb_out"]["kernel"]) + p["rgb_out"]["bias"]
    sigma = feat @ rnd(p["sigma_out"]["kernel"]) + p["sigma_out"]["bias"]
    return torch.cat([rgb, sigma], dim=-1)


def composite(raw: torch.Tensor, z: torch.Tensor):
    """``(rgb (R, 3), weights (R, S))`` of raw ``(R, S, 4)`` along ``z``."""
    sigma = torch.clamp_min(raw[..., 3], 0.0)
    colour = torch.sigmoid(raw[..., :3])
    delta = torch.diff(z, dim=-1)
    delta = torch.cat([delta, torch.full_like(delta[..., :1], TERMINAL_DELTA)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * delta)
    keep = torch.cumprod(1.0 - alpha, dim=-1)
    trans = torch.cat([torch.ones_like(keep[..., :1]), keep[..., :-1]], dim=-1)
    weights = alpha * trans
    return torch.sum(weights[..., None] * colour, dim=-2), weights


def shade(p: Dict, dims: Dict, o, d, z, rnd):
    """One network along ``z (R, S)``: ``(rgb, weights)``."""
    r, s = z.shape
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    enc = encode_xyz(pts.reshape(-1, 3), dims["n_freq_xyz"])
    encd = encode_dirs(d, dims["n_freq_dir"])
    encd = encd[:, None, :].expand(r, s, encd.shape[-1]).reshape(r * s, -1)
    raw = mlp(p, enc, encd, dims["leaky_alpha"], rnd)
    return composite(raw.reshape(r, s, 4), z)


# --------------------------------------------------------------------------- #
# Sampling                                                                     #
# --------------------------------------------------------------------------- #

def stratified(u: torch.Tensor, near: float, far: float) -> torch.Tensor:
    n = u.shape[-1]
    near_t = torch.tensor(near, dtype=torch.float32, device=u.device)
    far_t = torch.tensor(far, dtype=torch.float32, device=u.device)
    base = torch.linspace(float(near), float(far), n, dtype=torch.float32, device=u.device)
    return base + u * ((far_t - near_t) / n)


def sorted_uniforms(e: torch.Tensor) -> torch.Tensor:
    """Ascending order statistics from ``n + 1`` Exp(1) draws a row."""
    return torch.cumsum(e[..., :-1], dim=-1) / torch.sum(e, dim=-1, keepdim=True)


def resample(weights: torch.Tensor, z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw of ``u``'s count of z from the weights' PDF, linear
    between bin midpoints; differentiable in the weights and z."""
    n = weights.shape[-1]
    cdf = torch.cumsum(weights / (torch.sum(weights, dim=-1, keepdim=True) + CDF_EPS), dim=-1)
    idx = torch.searchsorted(cdf.detach().contiguous(), u.contiguous(), side="left")
    lo = torch.clamp_min(idx - 1, 0)
    hi = torch.clamp_max(idx, n - 1)
    cdf_lo, cdf_hi = torch.gather(cdf, -1, lo), torch.gather(cdf, -1, hi)
    mid = 0.5 * (z[..., 1:] + z[..., :-1])
    z_lo = torch.gather(mid, -1, torch.clamp(lo, 0, n - 2))
    z_hi = torch.gather(mid, -1, torch.clamp(hi, 0, n - 2))
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < DENOM_CLAMP, torch.full_like(denom, DENOM_CLAMP), denom)
    return z_lo + (u - cdf_lo) / denom * (z_hi - z_lo)


# --------------------------------------------------------------------------- #
# The training objective and the render                                        #
# --------------------------------------------------------------------------- #

def ray_sse(params: Dict, dims: Dict, o, d, rgb, strat_u, fine_u, rnd, z_follow=None):
    """Summed squared errors ``(coarse, fine)`` of a block of rays and the
    resampled z: the coarse pass on stratified z, the fine pass on the
    resampled z alone. With ``z_follow`` the fine pass takes those values
    in place of its own resampled ones, with their gradient through its own
    resampling."""
    z = stratified(strat_u, dims["near"], dims["far"])
    rgb_c, w = shade(params["coarse"], dims, o, d, z, rnd)
    z_f = resample(w, z, fine_u)
    own = z_f.detach()
    if z_follow is not None:
        z_f = z_follow + (z_f - own)
    rgb_f, _ = shade(params["fine"], dims, o, d, z_f, rnd)
    return torch.sum(torch.square(rgb - rgb_c)), torch.sum(torch.square(rgb - rgb_f)), own


def render_rays(params: Dict, dims: Dict, o, d, strat_u, fine_u, rnd) -> torch.Tensor:
    """The render path: the coarse pass, then the fine network over the
    resampled z merged with the coarse z. ``(R, 3)``."""
    z = stratified(strat_u, dims["near"], dims["far"])
    _, w = shade(params["coarse"], dims, o, d, z, rnd)
    z_new = resample(w, z, fine_u)
    merged, _ = torch.sort(torch.cat([z_new, z], dim=-1), dim=-1, stable=True)
    rgb, _ = shade(params["fine"], dims, o, d, merged, rnd)
    return rgb


@torch.no_grad()
def render_frame(params: Dict, dims: Dict, c2w, height: int, width: int, fov: float,
                 chunks: List[Dict], rnd, block: int = 8192) -> torch.Tensor:
    """A ``(height, width, 3)`` frame rendered chunk by chunk with the given
    draws (``chunks[i]``: ``strat_u``, ``fine_u`` of chunk ``i``, padded with
    copies of the last ray), in blocks of ``block`` rays."""
    o, d = image_rays(c2w, height, width, fov)
    n = o.shape[0]
    size = chunks[0]["strat_u"].shape[0]
    pad = len(chunks) * size - n
    if pad:
        o = torch.cat([o, o[-1:].expand(pad, 3)])
        d = torch.cat([d, d[-1:].expand(pad, 3)])
    out = []
    for i, draws in enumerate(chunks):
        for lo in range(0, size, block):
            rows = slice(i * size + lo, i * size + min(lo + block, size))
            sl = slice(lo, min(lo + block, size))
            out.append(render_rays(params, dims, o[rows], d[rows], draws["strat_u"][sl],
                                   draws["fine_u"][sl], rnd))
    return torch.cat(out)[:n].reshape(height, width, 3)
