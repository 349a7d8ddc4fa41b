"""The research kernels (B4, B5, B6, B7) and their wrappers.

Port of ``nerf_and_dietnerf_tpu/ops/research_kernels.py``. The
``backend="pallas_rm"`` family builds points and encodings in the kernel:

- B6 (``_forward_rays_pallas`` / ``_backward_rays_pallas``, the custom VJP
  ``_fused_raymarch`` / ``apply_raymarch_fused``): points ``o + z d``, the xyz
  and view-dir encodings and the radiance MLP from per-ray data, raw
  ``(R, S, 4)`` out; the backward gives the parameter gradients and dz. It
  runs B1/B2's tensor-core tiles on the encodings it builds (bf16 forward and
  backward on ``mma.sync``, f32 forward on 3xTF32 ``wgmma``), reading the
  weight packs of ``ops/raymarch_cuda`` (:func:`_rm_weights`); the f32
  backward runs f32 B2's 3xTF32 ``mma.sync`` tile, reading the F and B
  buffers of ``raymarch_cuda.t32_packs``.
- B7 (``_forward_rays_comp_pallas`` / ``_backward_rays_comp_pallas``,
  ``apply_raymarch_composited``): B6 followed by alpha compositing, ``(rgb
  (R, 3), weights (R, S))`` out; its backward takes cotangents on both. The
  bf16 forward and backward run the ray-group loops of
  ``csrc/comp_mma_tile.cuh`` on the bf16 tensor-core tiles (one forward per
  row), reading the F pack (forward) or the F and B packs (backward); the
  f32 forward and backward run the same loops on the 3xTF32 ``mma.sync``
  tiles of ``csrc/mlp_tf32_mma_tile.cuh``, reading the F (forward) or the F
  and B buffers of ``raymarch_cuda.t32_packs``. Every instance can return the
  raw values it composited (``raw=``); a forward composites bitwise the raw
  values its backward composites.

Both backwards give the rays, directions and view components structural-zero
cotangents, as the JAX package does: training differentiates the parameters
and z (the fine-resampling path) only.

The ``backend="pallas"`` family takes encodings made by torch ops, the xyz
encodings per row in **ray-major** order (row = ray * S + sample, the free
reshape of ``(rays, S, features)``) and the view-dir encodings **per ray**:

- B4 (``_forward_mlp_comp_pallas`` / ``_backward_mlp_comp_pallas``,
  ``apply_mlp_composited``, flag ``fuse_compositing``): the MLP and alpha
  compositing, ``(rgb (R, 3), weights (R, S))`` out. Its backward gives the
  gradients of the parameters, of both encodings and of z; that dz is the
  compositing's share only (the sample spacings), the share through the points
  reaches z through the xyz encodings' gradient and torch's encoding backward.
  Both run the ray-group loops of ``csrc/comp_mma_tile.cuh``, in bf16 on the
  tensor-core tiles (the forward reading the F pack, the backward the F and
  B packs, each row forwarded once), in f32 on the 3xTF32 ``mma.sync`` tiles
  (the F, or F and B, buffers of ``raymarch_cuda.t32_packs``). Every
  instance can return the raw values it composited (``raw=``).
- B5 (``_loss_mlp_comp_pallas``, ``apply_mlp_loss_composited``, flag
  ``fuse_fine_loss``): the fine-pass objective in one kernel, forward,
  compositing, MSE against the target pixels and the whole backward with no
  recompute. It returns the loss and has made the parameter gradients and the
  TOTAL dz (its encoding VJP reads the encoding's own neighbouring columns) by
  then; the encodings, directions and targets get structural-zero cotangents.
  It runs the same ray-group loop as B7's backward on the tensor-core tiles:
  in bf16 reading the F and B packs, in f32 on the 3xTF32 ``mma.sync``
  tiles reading the hi / lo buffers of ``raymarch_cuda.t32_packs``; both can
  return the raw values they composited (``raw=``).

The encodings are what the TPU kernel computes (``_encode_tile``): a direct
``sin(f_k x)`` with ``f_k = float32(pi 2^k)``, and cos as ``sin(f_k x + pi/2)``,
not the double-angle recurrence of ``core/encoding.py``, in the reference's
coordinate-major column order, so the MLP kernels' ``flatten_params`` layout
is reused unchanged.

The kernels are CUDA C++ in ``csrc/raymarch_*.cu`` and ``csrc/mlp_comp_*.cu`` /
``csrc/mlp_loss_comp.cu``, built and loaded by
``ops/kernel_lib.py`` (which also keeps their launch counts). Beside each is
its plain PyTorch version, which the wrappers take only for tensors on the
CPU; for a CUDA tensor they launch the kernel or raise. The plain B4, B5 and
B7 backwards take the compositing VJP from autograd through
``core.rendering.composite``, independent of the kernels' hand-written
recurrence.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from nerf_and_dietnerf_tpu_torch.core import rendering
from nerf_and_dietnerf_tpu_torch.models.mlp import MLPConfig, Params
from nerf_and_dietnerf_tpu_torch.ops.kernel_lib import (
    bwd_scratch,
    check_tensors,
    flat,
    launched,
    load,
    stream_of,
    uses_kernel,
)
from nerf_and_dietnerf_tpu_torch.ops.raymarch_cuda import (
    _forward_plain,
    _input_dtype,
    _weights_for,
    check_params,
    flatten_params,
    mlp_bwd_plain,
    mlp_fwd_plain,
    mlp_leaves,
    param_count,
    split_dparams,
    tree_from_leaves,
    unflatten_grads,
)

# Samples per ray the compositing kernels (B4, B5, B7) take: a block keeps a
# whole ray's raw values and cotangents in shared memory (MAX_S_COMP in
# csrc/composite_common.cuh; the kernels return an error above it).
MAX_SAMPLES_COMPOSITED = 512


# --------------------------------------------------------------------------- #
# Plain versions                                                               #
# --------------------------------------------------------------------------- #

def pack_rays(config: MLPConfig, rays_orig, rays_dirs, viewcomps) -> torch.Tensor:
    """``(R, 6 + D)`` f32: origin xyz | direction xyz | view components (the
    TPU kernel's per-ray input)."""
    parts = [rays_orig[:, :3], rays_dirs[:, :3]]
    if config.uses_view_dirs:
        parts.append(viewcomps)
    return torch.cat([p.float() for p in parts], dim=1).contiguous()


def _freqs(n: int, device) -> torch.Tensor:
    return torch.tensor([math.pi * 2.0 ** k for k in range(n)], dtype=torch.float32,
                        device=device)


def _thetas(v: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., C) -> (..., C, n, 2)``: ``f_k v`` and ``f_k v + pi/2``."""
    pf = v[..., None] * _freqs(n, v.device)
    return torch.stack([pf, pf + math.pi / 2], dim=-1)


def encode_rays_plain(config: MLPConfig, rd, z):
    """``(pts (R S, 3), x (R S, xyz), d (R S, dir) | None)`` in f32, rows
    ray-major, columns in the reference's order."""
    n_rays, n_samples = z.shape
    n = n_rays * n_samples
    pts = (rd[:, None, 0:3] + z[..., None] * rd[:, None, 3:6]).reshape(n, 3)
    sc = torch.sin(_thetas(pts, config.n_freq_xyz)).reshape(n, 3, -1)
    x = torch.cat([pts[..., None], sc], dim=-1).reshape(n, config.xyz_dim)
    d = None
    if config.uses_view_dirs:
        e = torch.sin(_thetas(rd[:, 6:], config.n_freq_dir)).reshape(n_rays, config.dir_dim)
        d = e[:, None, :].expand(n_rays, n_samples, config.dir_dim).reshape(n, config.dir_dim)
    return pts, x, d


def _mlp_inputs(config: MLPConfig, rd, z, cd):
    pts, x, d = encode_rays_plain(config, rd, z)
    return pts, x.to(cd), d.to(cd) if d is not None else None


def _dz_from_dx(config: MLPConfig, rd, pts, dx, n_samples: int) -> torch.Tensor:
    """The encoding VJP down to dz: ``dtheta = dx * cos(theta)``, ``dpts_c =
    sum f_k dtheta + dx[identity c]``, ``dz = dpts . d`` (per row)."""
    n = pts.shape[0]
    L = config.n_freq_xyz
    gx = dx.reshape(n, 3, 1 + 2 * L)
    dtheta = gx[..., 1:].reshape(n, 3, L, 2) * torch.cos(_thetas(pts, L))
    dpts = (dtheta * _freqs(L, pts.device)[:, None]).sum((-2, -1)) + gx[..., 0]
    return (dpts * rd[:, 3:6].repeat_interleave(n_samples, dim=0)).sum(-1)


def raymarch_fwd_plain(ws, bs, config: MLPConfig, rd, z, compute_dtype) -> torch.Tensor:
    """Plain version of B6's forward: raw ``(R, S, 4)`` f32."""
    _, x, d = _mlp_inputs(config, rd, z, compute_dtype)
    return mlp_fwd_plain(ws, bs, config, x, d, compute_dtype).reshape(*z.shape, 4)


def raymarch_bwd_plain(ws, bs, config: MLPConfig, rd, z, g, compute_dtype):
    """Plain version of B6's backward: ``(dws, dbs, dz (R, S))`` for the raw
    cotangent ``g`` (R, S, 4)."""
    pts, x, d = _mlp_inputs(config, rd, z, compute_dtype)
    dws, dbs, dx, _ = mlp_bwd_plain(ws, bs, config, x, d, g.reshape(-1, 4), compute_dtype)
    return dws, dbs, _dz_from_dx(config, rd, pts, dx, z.shape[1]).reshape(z.shape)


def composite_vjp(raw, z, g_rgb, g_w):
    """VJP of :func:`core.rendering.composite`'s ``(rgb, weights)`` w.r.t. the
    raw radiance and z, by autograd: ``(g_raw (R, S, 4), dz (R, S))``."""
    with torch.enable_grad():
        raw, z = raw.detach().requires_grad_(True), z.detach().requires_grad_(True)
        res = rendering.composite(raw, z)
        return torch.autograd.grad((res.rgb, res.weights), (raw, z), (g_rgb, g_w))


def kink_of(raw, raw_sigma):
    """``raw`` (R, S, 4) with each sample's sigma on the side of the
    compositing's kink (``max(sigma, 0)``; the sigma cotangent is 0 below
    it) on which ``raw_sigma`` (R, S) lies: sigma negated where the two signs
    differ. A kernel's checks pass its own raw sigma, so that a sample whose
    sigma lies within the rounding noise of 0 takes the kernel's side in the
    plain version too; None keeps ``raw``."""
    if raw_sigma is None:
        return raw
    s = raw[..., 3]
    s = torch.where((s > 0) == (raw_sigma > 0), s, -s)
    return torch.cat([raw[..., :3], s[..., None]], dim=-1)


def _raw_plain(ws, bs, config: MLPConfig, x, d, z, cd, work, raw_sigma=None):
    """The raw radiance (R, S, 4) f32 the plain compositing reads, its MLP's
    products and sums in ``work`` (float64: the same roundings to the
    compute type with nearly exact sums; the compositing stays f32, as in the
    kernels), each sample on ``raw_sigma``'s side of the kink
    (:func:`kink_of`)."""
    raw = _forward_plain(ws, bs, config, x, d, cd, work)[0].float()
    return kink_of(raw.reshape(*z.shape, 4), raw_sigma)


def raymarch_comp_fwd_plain(ws, bs, config: MLPConfig, rd, z, compute_dtype,
                            work=torch.float32, raw_sigma=None):
    """Plain version of B7's forward: ``(rgb (R, 3), weights (R, S))``; the
    MLP's products and sums in ``work``, the compositing's kink on
    ``raw_sigma``'s side (:func:`_raw_plain`)."""
    _, x, d = _mlp_inputs(config, rd, z, compute_dtype)
    res = rendering.composite(_raw_plain(ws, bs, config, x, d, z, compute_dtype, work,
                                         raw_sigma), z)
    return res.rgb, res.weights


def raymarch_comp_bwd_plain(ws, bs, config: MLPConfig, rd, z, g_rgb, g_w, compute_dtype,
                            work=torch.float32, raw_sigma=None):
    """Plain version of B7's backward: ``(dws, dbs, dz)``, dz the
    compositing's share plus the points'; the MLP's products and sums in
    ``work``, the compositing's kink on ``raw_sigma``'s side
    (:func:`_raw_plain`)."""
    pts, x, d = _mlp_inputs(config, rd, z, compute_dtype)
    raw = _raw_plain(ws, bs, config, x, d, z, compute_dtype, work, raw_sigma)
    g_raw, dz_comp = composite_vjp(raw, z, g_rgb, g_w)
    dws, dbs, dx, _ = mlp_bwd_plain(ws, bs, config, x, d, g_raw.reshape(-1, 4), compute_dtype,
                                    work)
    return dws, dbs, dz_comp + _dz_from_dx(config, rd, pts, dx, z.shape[1]).reshape(z.shape)


def _dir_rows(config: MLPConfig, encd, n_samples: int, cd):
    """The per-ray view-dir encodings ``(R, dir)``, rounded to the compute
    type, as one row per sample ``(R S, dir)``; None for the xyz-only variant."""
    if not config.uses_view_dirs:
        return None
    d = encd.float().to(cd)
    return d[:, None, :].expand(d.shape[0], n_samples, d.shape[1]).reshape(-1, d.shape[1])


def _raw_on_encodings(ws, bs, config: MLPConfig, enc, encd, z, cd):
    d = _dir_rows(config, encd, z.shape[1], cd)
    return mlp_fwd_plain(ws, bs, config, enc, d, cd).reshape(*z.shape, 4), d


def _dz_from_encoding(config: MLPConfig, enc, denc, dvec, n_samples: int) -> torch.Tensor:
    """The points' share of dz per row, from the xyz-encoding gradient
    ``denc`` and the encoding's own neighbouring columns: per coordinate the
    columns are ``[c, sin f0 c, cos f0 c, ...]``, so d(column)/dc is 1, ``f_k``
    times the cos column to the right of a sin column, and ``-f_k`` times the
    sin column to the left of a cos column; then ``dz = dpts . dvec``."""
    n, L = enc.shape[0], config.n_freq_xyz
    e = enc.float().reshape(n, 3, 1 + 2 * L)
    g = denc.reshape(n, 3, 1 + 2 * L)
    f = _freqs(L, enc.device)
    dpts = (g[..., 0] + (g[..., 1::2] * (f * e[..., 2::2])).sum(-1)
            + (g[..., 2::2] * (-f * e[..., 1::2])).sum(-1))
    return (dpts * dvec.repeat_interleave(n_samples, dim=0)).sum(-1)


def mlp_comp_fwd_plain(ws, bs, config: MLPConfig, enc, encd, z, compute_dtype,
                       work=torch.float32, raw_sigma=None):
    """Plain version of B4's forward: ``(rgb (R, 3), weights (R, S))`` from
    ``enc`` (R S, xyz) in the compute type, ``encd`` (R, dir) f32, z (R, S);
    the MLP's products and sums in ``work``, the compositing's kink on
    ``raw_sigma``'s side (:func:`_raw_plain`)."""
    d = _dir_rows(config, encd, z.shape[1], compute_dtype)
    res = rendering.composite(_raw_plain(ws, bs, config, enc, d, z, compute_dtype, work,
                                         raw_sigma), z)
    return res.rgb, res.weights


def mlp_comp_bwd_plain(ws, bs, config: MLPConfig, enc, encd, z, g_rgb, g_w, compute_dtype,
                       work=torch.float32, raw_sigma=None):
    """Plain version of B4's backward: ``(dws, dbs, denc (R S, xyz), dencd
    (R, dir) | None, dz (R, S))``; dz is the compositing's share only; the
    MLP's products and sums in ``work``, the compositing's kink on
    ``raw_sigma``'s side (:func:`_raw_plain`)."""
    d = _dir_rows(config, encd, z.shape[1], compute_dtype)
    raw = _raw_plain(ws, bs, config, enc, d, z, compute_dtype, work, raw_sigma)
    g_raw, dz = composite_vjp(raw, z, g_rgb, g_w)
    dws, dbs, denc, dd = mlp_bwd_plain(ws, bs, config, enc, d, g_raw.reshape(-1, 4),
                                       compute_dtype, work)
    dencd = dd.reshape(*z.shape, -1).sum(1) if dd is not None else None
    return dws, dbs, denc, dencd, dz


def mlp_loss_comp_plain(ws, bs, config: MLPConfig, enc, encd, z, dvec, target, compute_dtype,
                        work=torch.float32, raw_sigma=None):
    """Plain version of B5: ``(mse (), dz (R, S), dws, dbs)``: the mean squared
    error of the composited pixels against ``target`` (R, 3), the total dz (the
    compositing's share plus the points', ``dvec`` (R, 3) being the rays'
    unnormalised directions) and the parameter gradients of that loss; the
    MLP's products and sums in ``work``, the compositing's kink on
    ``raw_sigma``'s side (:func:`_raw_plain`)."""
    d = _dir_rows(config, encd, z.shape[1], compute_dtype)
    raw = _raw_plain(ws, bs, config, enc, d, z, compute_dtype, work, raw_sigma)
    inv_n = 1.0 / (3 * z.shape[0])
    err = rendering.composite(raw, z).rgb - target
    mse = torch.sum(err * err) * inv_n
    g_raw, dz_comp = composite_vjp(raw, z, (2.0 * inv_n) * err, torch.zeros_like(z))
    dws, dbs, denc, _ = mlp_bwd_plain(ws, bs, config, enc, d, g_raw.reshape(-1, 4),
                                      compute_dtype, work)
    dz_pts = _dz_from_encoding(config, enc, denc, dvec, z.shape[1]).reshape(z.shape)
    return mse, dz_comp + dz_pts, dws, dbs


# --------------------------------------------------------------------------- #
# Wrappers                                                                     #
# --------------------------------------------------------------------------- #

def _check_samples(z) -> None:
    """The compositing kernels' limit (B4, B5, B7), on every device, so a
    config that would fail on the card fails on the CPU too. Within it a
    block's shared memory always fits (the sources assert it at the maximum)."""
    if z.shape[1] > MAX_SAMPLES_COMPOSITED:
        raise ValueError(f"{z.shape[1]} samples per ray exceed the compositing kernels' "
                         f"maximum of {MAX_SAMPLES_COMPOSITED}")


def _check_rays(config: MLPConfig, ws, bs, rd, z, cd):
    check_params(config, ws, bs, cd, rd.device)
    n_rays, n_samples = z.shape
    width = 6 + (config.n_angles + 1 if config.uses_view_dirs else 0)
    check_tensors([(rd, (n_rays, width), torch.float32), (z, (n_rays, n_samples), torch.float32)],
                  rd.device)
    if n_rays * n_samples >= 2 ** 31:
        raise ValueError(f"{n_rays} x {n_samples} rows exceed the kernels' 32-bit row index")


def _ray_args(config: MLPConfig, rd, z):
    """The kernels' trailing arguments: R, S, L, Ld, D, xyz, dir, hid, last,
    alpha, stream."""
    has_dir = config.uses_view_dirs
    return (*z.shape, config.n_freq_xyz, config.n_freq_dir if has_dir else 0,
            config.n_angles + 1 if has_dir else 0, config.xyz_dim,
            config.dir_dim if has_dir else 0, config.hidden_dim, config.last_hidden_dim,
            config.leaky_relu_alpha, stream_of(rd.device))


def _is_bf16(cd) -> int:
    return int(cd == torch.bfloat16)


def _rm_weights(lib, ws, config: MLPConfig, cd, backward: bool):
    """The weight buffers the B6 or B7 library ``lib`` reads, from
    ``raymarch_cuda._weights_for`` (which checks a pack's size against the
    library's): in bf16 the F pack (forward) or the F and B packs (backward);
    the f32 forward's TF32 hi / lo buffer where the library runs it on the
    tensor cores (``nerf_rm_fwd_tf32_tile``), else the flat weights; the f32
    backward's F and B buffers of ``t32_packs``."""
    if backward:
        kinds = ("tf", "tb") if cd == torch.float32 else ("f", "b")
    elif cd == torch.bfloat16:
        kinds = ("f",)
    else:
        dir_dim = config.dir_dim if config.uses_view_dirs else 0
        kinds = ("t",) if lib.nerf_rm_fwd_tf32_tile(config.xyz_dim, dir_dim) else ("f",)
    return _weights_for(lib, ws, config, cd, kinds)


def raymarch_fwd(ws, bs, config: MLPConfig, rd, z, compute_dtype) -> torch.Tensor:
    """B6 forward: raw ``(R, S, 4)`` f32 from rays ``rd`` (:func:`pack_rays`)
    and z ``(R, S)`` f32; ``ws`` / ``bs`` from ``flatten_params``."""
    if not uses_kernel(rd):
        return raymarch_fwd_plain(ws, bs, config, rd, z, compute_dtype)
    _check_rays(config, ws, bs, rd, z, compute_dtype)
    out = torch.empty((*z.shape, 4), dtype=torch.float32, device=rd.device)
    if out.numel() == 0:
        return out
    lib = load("raymarch_fwd")
    (w,), b = _rm_weights(lib, ws, config, compute_dtype, False), flat(bs)
    rc = lib.nerf_rm_fwd(
        _is_bf16(compute_dtype), int(config.uses_view_dirs), rd.data_ptr(), z.data_ptr(),
        w.data_ptr(), b.data_ptr(), out.data_ptr(), *_ray_args(config, rd, z))
    launched("raymarch_fwd", rc)
    return out


def raymarch_bwd(ws, bs, config: MLPConfig, rd, z, g, compute_dtype):
    """B6 backward: ``(dws, dbs, dz (R, S))`` for the raw cotangent ``g``
    (R, S, 4) f32; parameter gradients are bitwise reproducible."""
    if not uses_kernel(rd):
        return raymarch_bwd_plain(ws, bs, config, rd, z, g, compute_dtype)
    _check_rays(config, ws, bs, rd, z, compute_dtype)
    check_tensors([(g, (*z.shape, 4), torch.float32)], rd.device)
    dev = rd.device
    lib = load("raymarch_bwd")
    dz = torch.empty(z.shape, dtype=torch.float32, device=dev)
    dparams = torch.empty((param_count(config, lib),), dtype=torch.float32, device=dev)
    if dz.numel() == 0:
        dparams.zero_()
    else:
        is_bf16 = _is_bf16(compute_dtype)
        rows = lib.nerf_mlp_bwd_tile_rows(is_bf16)
        partial, acts, n_blocks = bwd_scratch(dparams.numel(), compute_dtype, dev,
                                              -(-dz.numel() // rows),
                                              lib.nerf_mlp_bwd_tile_act_elems(is_bf16))
        # Each block's dx slab (csrc/raymarch_bwd.cu).
        dxs = torch.empty((n_blocks * rows * config.xyz_dim,), dtype=torch.float32, device=dev)
        (w, wt), b = _rm_weights(lib, ws, config, compute_dtype, True), flat(bs)
        rc = lib.nerf_rm_bwd(
            is_bf16, int(config.uses_view_dirs), rd.data_ptr(), z.data_ptr(), w.data_ptr(),
            wt.data_ptr(), b.data_ptr(), g.data_ptr(), dz.data_ptr(), partial.data_ptr(),
            acts.data_ptr(), dxs.data_ptr(), dparams.data_ptr(), n_blocks,
            *_ray_args(config, rd, z))
        launched("raymarch_bwd", rc)
    return (*split_dparams(dparams, config), dz)


def raymarch_comp_fwd(ws, bs, config: MLPConfig, rd, z, compute_dtype, raw=None):
    """B7 forward: ``(rgb (R, 3), weights (R, S))`` f32; at most
    :data:`MAX_SAMPLES_COMPOSITED` samples per ray. ``raw``: None, or an (R,
    S, 4) f32 tensor that receives the raw values the kernel composited (on
    the CPU the plain forward's)."""
    _check_samples(z)
    _raw_out(raw, z, rd.device)
    if not uses_kernel(rd):
        if raw is not None:
            raw.copy_(raymarch_fwd_plain(ws, bs, config, rd, z, compute_dtype))
        return raymarch_comp_fwd_plain(ws, bs, config, rd, z, compute_dtype)
    _check_rays(config, ws, bs, rd, z, compute_dtype)
    dev = rd.device
    rgb = torch.empty((z.shape[0], 3), dtype=torch.float32, device=dev)
    weights = torch.empty(z.shape, dtype=torch.float32, device=dev)
    if weights.numel() == 0:
        return rgb.zero_(), weights
    lib = load("raymarch_comp_fwd")
    (w,), b = _weights_for(lib, ws, config, compute_dtype, _fwd_kinds(compute_dtype)), flat(bs)
    rc = lib.nerf_rm_comp_fwd(
        _is_bf16(compute_dtype), int(config.uses_view_dirs), rd.data_ptr(), z.data_ptr(),
        w.data_ptr(), b.data_ptr(), rgb.data_ptr(), weights.data_ptr(), _ptr(raw),
        *_ray_args(config, rd, z))
    launched("raymarch_comp_fwd", rc)
    return rgb, weights


def _comp_bwd_scratch(lib, n_params: int, config: MLPConfig, cd, z, dev, width=None):
    """``(partial, acts, slab, n_blocks)`` of a compositing backward (the
    library ``lib`` of B7's backward, B5 or B4's backward), sized from the
    library's exports for the compute type (``csrc/comp_exports.cuh``): ray
    groups of one tile (bf16 128 rows, f32 64; a ray over several tiles
    where S is larger), every tile's activation slots and each block's f32
    slab of the tile's rows, ``width`` columns each (dx rows: xyz, the
    default; B4's dd rows: dir; 0 for none, None)."""
    is_bf16 = _is_bf16(cd)
    n_rays, n_samples = z.shape
    partial, acts, n_blocks = bwd_scratch(n_params, cd, dev,
                                          lib.nerf_comp_groups(is_bf16, n_rays, n_samples),
                                          lib.nerf_comp_act_elems(is_bf16, n_samples))
    rows = lib.nerf_comp_dx_rows(is_bf16) * (config.xyz_dim if width is None else width)
    slab = torch.empty((n_blocks * rows,), dtype=torch.float32, device=dev) if rows else None
    return partial, acts, slab, n_blocks


def _raw_out(raw, z, dev):
    """Check the optional raw output of a compositing kernel: (R, S, 4) f32
    on the inputs' device."""
    if raw is not None:
        check_tensors([(raw, (*z.shape, 4), torch.float32)], dev)


def _fwd_kinds(cd):
    """The weight buffer a compositing forward (B4, B7) reads: the F pack in
    bf16, the F buffer of ``raymarch_cuda.t32_packs`` in f32."""
    return ("f",) if cd == torch.bfloat16 else ("tf",)


def raymarch_comp_bwd(ws, bs, config: MLPConfig, rd, z, g_rgb, g_w, compute_dtype, raw=None):
    """B7 backward: ``(dws, dbs, dz (R, S))`` for the cotangents ``g_rgb``
    (R, 3) and ``g_w`` (R, S) f32; parameter gradients bitwise reproducible.
    ``raw``: None, or an (R, S, 4) f32 tensor that receives the raw values
    the kernel composited (the checks read it; on the CPU the plain
    forward's)."""
    _check_samples(z)
    _raw_out(raw, z, rd.device)
    if not uses_kernel(rd):
        if raw is not None:
            raw.copy_(raymarch_fwd_plain(ws, bs, config, rd, z, compute_dtype))
        return raymarch_comp_bwd_plain(ws, bs, config, rd, z, g_rgb, g_w, compute_dtype)
    _check_rays(config, ws, bs, rd, z, compute_dtype)
    check_tensors([(g_rgb, (z.shape[0], 3), torch.float32), (g_w, z.shape, torch.float32)],
                  rd.device)
    dev = rd.device
    lib = load("raymarch_comp_bwd")
    dz = torch.empty(z.shape, dtype=torch.float32, device=dev)
    dparams = torch.empty((param_count(config, lib),), dtype=torch.float32, device=dev)
    if dz.numel() == 0:
        dparams.zero_()
    else:
        is_bf16 = _is_bf16(compute_dtype)
        partial, acts, dxs, n_blocks = _comp_bwd_scratch(lib, dparams.numel(), config,
                                                         compute_dtype, z, dev)
        (w, wt), b = _rm_weights(lib, ws, config, compute_dtype, True), flat(bs)
        rc = lib.nerf_rm_comp_bwd(
            is_bf16, int(config.uses_view_dirs), rd.data_ptr(), z.data_ptr(), w.data_ptr(),
            wt.data_ptr(), b.data_ptr(), g_rgb.data_ptr(), g_w.data_ptr(), dz.data_ptr(),
            _ptr(raw), partial.data_ptr(), acts.data_ptr(), _ptr(dxs), dparams.data_ptr(),
            n_blocks, *_ray_args(config, rd, z))
        launched("raymarch_comp_bwd", rc)
    return (*split_dparams(dparams, config), dz)


def _check_encodings(config: MLPConfig, ws, bs, enc, encd, z, cd):
    check_params(config, ws, bs, cd, enc.device)
    n_rays, n_samples = z.shape
    if n_rays * n_samples >= 2 ** 31:
        raise ValueError(f"{n_rays} x {n_samples} rows exceed the kernels' 32-bit row index")
    tensors = [(enc, (n_rays * n_samples, config.xyz_dim), cd),
               (z, (n_rays, n_samples), torch.float32)]
    if config.uses_view_dirs:
        tensors.append((encd, (n_rays, config.dir_dim), torch.float32))
    check_tensors(tensors, enc.device)


def _comp_args(config: MLPConfig, z):
    """The B4/B5 kernels' trailing arguments: R, S, xyz, dir, hid, last, alpha."""
    return (*z.shape, config.xyz_dim, config.dir_dim if config.uses_view_dirs else 0,
            config.hidden_dim, config.last_hidden_dim, config.leaky_relu_alpha)


def _ptr(t):
    return None if t is None else t.data_ptr()


def mlp_comp_fwd(ws, bs, config: MLPConfig, enc, encd, z, compute_dtype, raw=None,
                 before_launch=None):
    """B4 forward: ``(rgb (R, 3), weights (R, S))`` f32 from ``enc`` (R S, xyz)
    in the compute type (ray-major rows), ``encd`` (R, dir) f32 per ray (None
    without view dirs) and z (R, S) f32; at most
    :data:`MAX_SAMPLES_COMPOSITED` samples per ray. ``raw`` as
    :func:`mlp_comp_bwd`'s. ``before_launch``, if given, runs right before
    the kernel's launch (as ``raymarch_cuda.mlp_bwd``'s: the card's checks
    leave NaN in shared memory there)."""
    _check_samples(z)
    _raw_out(raw, z, enc.device)
    if not uses_kernel(enc):
        if raw is not None:
            raw.copy_(_raw_on_encodings(ws, bs, config, enc, encd, z, compute_dtype)[0])
        return mlp_comp_fwd_plain(ws, bs, config, enc, encd, z, compute_dtype)
    _check_encodings(config, ws, bs, enc, encd, z, compute_dtype)
    dev = enc.device
    rgb = torch.empty((z.shape[0], 3), dtype=torch.float32, device=dev)
    weights = torch.empty(z.shape, dtype=torch.float32, device=dev)
    if weights.numel() == 0:
        return rgb.zero_(), weights
    lib = load("mlp_comp_fwd")
    (w,), b = _weights_for(lib, ws, config, compute_dtype, _fwd_kinds(compute_dtype)), flat(bs)
    if before_launch is not None:
        before_launch()
    rc = lib.nerf_mlp_comp_fwd(
        _is_bf16(compute_dtype), int(config.uses_view_dirs), enc.data_ptr(), _ptr(encd),
        z.data_ptr(), w.data_ptr(), b.data_ptr(), rgb.data_ptr(), weights.data_ptr(), _ptr(raw),
        *_comp_args(config, z), stream_of(dev))
    launched("mlp_comp_fwd", rc)
    return rgb, weights


def mlp_comp_bwd(ws, bs, config: MLPConfig, enc, encd, z, g_rgb, g_w, compute_dtype, raw=None):
    """B4 backward: ``(dws, dbs, denc (R S, xyz), dencd (R, dir) | None, dz
    (R, S))`` f32 for the cotangents ``g_rgb`` (R, 3) and ``g_w`` (R, S) f32.
    dz is the compositing's share only. The parameter gradients and dencd are
    bitwise reproducible. ``raw`` as :func:`raymarch_comp_bwd`'s."""
    _check_samples(z)
    _raw_out(raw, z, enc.device)
    if not uses_kernel(enc):
        if raw is not None:
            raw.copy_(_raw_on_encodings(ws, bs, config, enc, encd, z, compute_dtype)[0])
        return mlp_comp_bwd_plain(ws, bs, config, enc, encd, z, g_rgb, g_w, compute_dtype)
    _check_encodings(config, ws, bs, enc, encd, z, compute_dtype)
    dev = enc.device
    check_tensors([(g_rgb, (z.shape[0], 3), torch.float32), (g_w, z.shape, torch.float32)], dev)
    lib = load("mlp_comp_bwd")
    has_dir = config.uses_view_dirs
    denc = torch.empty(enc.shape, dtype=torch.float32, device=dev)
    dencd = torch.empty(encd.shape, dtype=torch.float32, device=dev) if has_dir else None
    dz = torch.empty(z.shape, dtype=torch.float32, device=dev)
    dparams = torch.empty((param_count(config, lib),), dtype=torch.float32, device=dev)
    if dz.numel() == 0:
        dparams.zero_()
        if has_dir:
            dencd.zero_()
    else:
        # Each block's slab of dd rows (csrc/mlp_comp_bwd.cu), none without
        # view dirs.
        partial, acts, dds, n_blocks = _comp_bwd_scratch(
            lib, dparams.numel(), config, compute_dtype, z, dev,
            config.dir_dim if has_dir else 0)
        kinds = ("f", "b") if compute_dtype == torch.bfloat16 else ("tf", "tb")
        (w, wt), b = _weights_for(lib, ws, config, compute_dtype, kinds), flat(bs)
        rc = lib.nerf_mlp_comp_bwd(
            _is_bf16(compute_dtype), int(has_dir), enc.data_ptr(), _ptr(encd), z.data_ptr(),
            w.data_ptr(), wt.data_ptr(), b.data_ptr(), g_rgb.data_ptr(), g_w.data_ptr(),
            denc.data_ptr(), _ptr(dencd), dz.data_ptr(), _ptr(raw), partial.data_ptr(),
            acts.data_ptr(), _ptr(dds), dparams.data_ptr(), n_blocks, *_comp_args(config, z),
            stream_of(dev))
        launched("mlp_comp_bwd", rc)
    return (*split_dparams(dparams, config), denc, dencd, dz)


def mlp_loss_comp(ws, bs, config: MLPConfig, enc, encd, z, dvec, target, compute_dtype,
                  raw=None):
    """B5: ``(mse (), dz (R, S), dws, dbs)`` f32 in one launch: the mean
    squared error of the composited pixels against ``target`` (R, 3) f32, and
    that loss's total dz and parameter gradients; ``dvec`` (R, 3) f32 are the
    rays' unnormalised directions. All three are bitwise reproducible.
    ``raw`` as :func:`raymarch_comp_bwd`'s."""
    _check_samples(z)
    _raw_out(raw, z, enc.device)
    if not uses_kernel(enc):
        if raw is not None:
            raw.copy_(_raw_on_encodings(ws, bs, config, enc, encd, z, compute_dtype)[0])
        return mlp_loss_comp_plain(ws, bs, config, enc, encd, z, dvec, target, compute_dtype)
    _check_encodings(config, ws, bs, enc, encd, z, compute_dtype)
    dev = enc.device
    n_rays = z.shape[0]
    check_tensors([(dvec, (n_rays, 3), torch.float32), (target, (n_rays, 3), torch.float32)], dev)
    inv_n = 1.0 / (3 * n_rays)
    lib = load("mlp_loss_comp")
    n_params = param_count(config, lib)
    dz = torch.empty(z.shape, dtype=torch.float32, device=dev)
    out = torch.empty((n_params + 1,), dtype=torch.float32, device=dev)  # dparams, then the loss
    if dz.numel() == 0:
        out.zero_()
    else:
        partial, acts, dxs, n_blocks = _comp_bwd_scratch(lib, n_params + 1, config,
                                                         compute_dtype, z, dev)
        kinds = ("f", "b") if compute_dtype == torch.bfloat16 else ("tf", "tb")
        w, wt = _weights_for(lib, ws, config, compute_dtype, kinds)
        b = flat(bs)
        rc = lib.nerf_mlp_loss_comp(
            _is_bf16(compute_dtype), int(config.uses_view_dirs), enc.data_ptr(), _ptr(encd),
            z.data_ptr(), dvec.data_ptr(), target.data_ptr(), w.data_ptr(), wt.data_ptr(),
            b.data_ptr(), dz.data_ptr(), _ptr(raw), partial.data_ptr(), acts.data_ptr(),
            _ptr(dxs), out.data_ptr(), n_blocks, *_comp_args(config, z), inv_n, stream_of(dev))
        launched("mlp_loss_comp", rc)
    return (out[n_params], dz, *split_dparams(out[:n_params], config))


# --------------------------------------------------------------------------- #
# autograd.Functions and the JAX package's entry points                        #
# --------------------------------------------------------------------------- #

def _param_grads(dws, dbs, leaves, config: MLPConfig):
    dleaves = mlp_leaves(unflatten_grads(dws, dbs, config), config)
    return [dl.to(leaf.dtype) for dl, leaf in zip(dleaves, leaves)]


def _ray_grad(ctx, rd):
    """The structural-zero cotangent of the packed rays."""
    return torch.zeros_like(rd) if ctx.needs_input_grad[2] else None


class FusedRaymarch(torch.autograd.Function):
    """B6 forward and backward. Inputs after the packed rays and z are the
    parameter leaves of ``mlp_leaves``."""

    @staticmethod
    def forward(ctx, config, cd, rd, z, *leaves):
        ws, bs = flatten_params(tree_from_leaves(leaves, config), config, cd)
        ctx.config, ctx.cd = config, cd
        ctx.save_for_backward(rd, z, *leaves)
        return raymarch_fwd(ws, bs, config, rd, z, cd)

    @staticmethod
    def backward(ctx, g):
        config, cd = ctx.config, ctx.cd
        rd, z, *leaves = ctx.saved_tensors
        ws, bs = flatten_params(tree_from_leaves(leaves, config), config, cd)
        dws, dbs, dz = raymarch_bwd(ws, bs, config, rd, z, g.float().contiguous(), cd)
        return (None, None, _ray_grad(ctx, rd), dz, *_param_grads(dws, dbs, leaves, config))


class FusedRaymarchComposited(torch.autograd.Function):
    """B7 forward and backward: outputs ``(rgb, weights)``, cotangents on both."""

    @staticmethod
    def forward(ctx, config, cd, rd, z, *leaves):
        ws, bs = flatten_params(tree_from_leaves(leaves, config), config, cd)
        ctx.config, ctx.cd = config, cd
        ctx.save_for_backward(rd, z, *leaves)
        return raymarch_comp_fwd(ws, bs, config, rd, z, cd)

    @staticmethod
    def backward(ctx, g_rgb, g_w):
        config, cd = ctx.config, ctx.cd
        rd, z, *leaves = ctx.saved_tensors
        ws, bs = flatten_params(tree_from_leaves(leaves, config), config, cd)
        dws, dbs, dz = raymarch_comp_bwd(ws, bs, config, rd, z, g_rgb.float().contiguous(),
                                         g_w.float().contiguous(), cd)
        return (None, None, _ray_grad(ctx, rd), dz, *_param_grads(dws, dbs, leaves, config))


def _ray_inputs(config: MLPConfig, rays_orig, rays_dirs, viewcomps, z_values):
    if config.uses_view_dirs and viewcomps is None:
        raise ValueError("this MLP config requires view-direction components")
    return pack_rays(config, rays_orig, rays_dirs, viewcomps), z_values.float().contiguous()


def apply_raymarch_fused(params: Params, config: MLPConfig, rays_orig: torch.Tensor,
                         rays_dirs: torch.Tensor, viewcomps: Optional[torch.Tensor],
                         z_values: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Fully fused ray-march MLP evaluation (B6).

    :param rays_orig: ``(n_rays, >=3)`` ray origins (homogeneous ok).
    :param rays_dirs: ``(n_rays, >=3)`` unnormalized ray directions.
    :param viewcomps: ``(n_rays, n_angles + 1)`` view-direction components
        (``core/cameras.view_direction_components``), or None for xyz-only.
    :param z_values: ``(n_rays, S)``.
    :return: raw radiance ``(n_rays, S, 4)`` float32. Differentiable w.r.t.
        ``params`` and ``z_values``; the ray cotangents are structural zeros.
    """
    rd, z = _ray_inputs(config, rays_orig, rays_dirs, viewcomps, z_values)
    return FusedRaymarch.apply(config, compute_dtype, rd, z, *mlp_leaves(params, config))


def apply_raymarch_composited(params: Params, config: MLPConfig, rays_orig: torch.Tensor,
                              rays_dirs: torch.Tensor, viewcomps: Optional[torch.Tensor],
                              z_values: torch.Tensor, compute_dtype=torch.bfloat16):
    """Fully fused ray-march + alpha compositing (B7): same inputs as
    :func:`apply_raymarch_fused`, ``(rgb (n_rays, 3), weights (n_rays, S))``
    float32 out. Differentiable w.r.t. ``params`` and ``z_values`` (through
    the points and the sample spacings); the ray cotangents are structural
    zeros, so do not use it where the rays themselves are optimized."""
    rd, z = _ray_inputs(config, rays_orig, rays_dirs, viewcomps, z_values)
    return FusedRaymarchComposited.apply(config, compute_dtype, rd, z,
                                         *mlp_leaves(params, config))


def _zeros_if_needed(needed: bool, spec):
    """A structural-zero cotangent for an input of ``spec = (shape, dtype,
    device)``, or None where none is asked for (or there is no such input)."""
    if not needed or spec is None:
        return None
    shape, dtype, device = spec
    return torch.zeros(shape, dtype=dtype, device=device)


def _spec(t):
    return None if t is None else (t.shape, t.dtype, t.device)


class FusedMLPComposited(torch.autograd.Function):
    """B4 forward and backward: outputs ``(rgb, weights)``, cotangents on both;
    gradients for the parameters, both encodings and z."""

    @staticmethod
    def forward(ctx, config, cd, enc, encd, z, *leaves):
        ws, bs = flatten_params(tree_from_leaves(leaves, config), config, cd)
        x = enc.to(_input_dtype(cd)).contiguous()
        d = encd.float().contiguous() if encd is not None else None
        ctx.config, ctx.cd, ctx.enc_dtype = config, cd, enc.dtype
        ctx.encd_dtype = encd.dtype if encd is not None else None
        ctx.save_for_backward(x, d, z, *leaves)
        return mlp_comp_fwd(ws, bs, config, x, d, z, cd)

    @staticmethod
    def backward(ctx, g_rgb, g_w):
        config, cd = ctx.config, ctx.cd
        x, d, z, *leaves = ctx.saved_tensors
        ws, bs = flatten_params(tree_from_leaves(leaves, config), config, cd)
        dws, dbs, denc, dencd, dz = mlp_comp_bwd(
            ws, bs, config, x, d, z, g_rgb.float().contiguous(), g_w.float().contiguous(), cd)
        if dencd is not None:
            dencd = dencd.to(ctx.encd_dtype)
        return (None, None, denc.to(ctx.enc_dtype), dencd, dz,
                *_param_grads(dws, dbs, leaves, config))


class FusedMLPLossComposited(torch.autograd.Function):
    """B5: the loss, with its gradients made by the same launch. ``forward``
    keeps the total dz and the parameter gradients (not the activations, which
    live only in the wrapper's scratch); ``backward`` scales them by the
    incoming cotangent. The encodings, directions and targets get zeros."""

    @staticmethod
    def forward(ctx, config, cd, enc, encd, z, dvec, target, *leaves):
        ws, bs = flatten_params(tree_from_leaves(leaves, config), config, cd)
        x = enc.to(_input_dtype(cd)).contiguous()
        d = encd.float().contiguous() if encd is not None else None
        mse, dz, dws, dbs = mlp_loss_comp(ws, bs, config, x, d, z, dvec.float().contiguous(),
                                          target.float().contiguous(), cd)
        ctx.zero_specs = [_spec(t) for t in (enc, encd, dvec, target)]
        ctx.save_for_backward(dz, *_param_grads(dws, dbs, leaves, config))
        return mse

    @staticmethod
    def backward(ctx, g):
        dz, *dleaves = ctx.saved_tensors
        g = g.float()
        need = ctx.needs_input_grad
        z_enc, z_encd, z_dvec, z_target = (
            _zeros_if_needed(n, sp) for n, sp in zip((need[2], need[3], need[5], need[6]),
                                                     ctx.zero_specs))
        return (None, None, z_enc, z_encd, dz * g if need[4] else None, z_dvec, z_target,
                *[(dl.float() * g).to(dl.dtype) for dl in dleaves])


def _encoding_inputs(config: MLPConfig, enc_dir_ray, z_values):
    if config.uses_view_dirs and enc_dir_ray is None:
        raise ValueError("this MLP config requires per-ray view-dir encodings")
    return enc_dir_ray if config.uses_view_dirs else None, z_values.float().contiguous()


def apply_mlp_composited(params: Params, config: MLPConfig, enc_xyz: torch.Tensor,
                         enc_dir_ray: Optional[torch.Tensor], z_values: torch.Tensor,
                         compute_dtype=torch.bfloat16):
    """Fused MLP + alpha compositing over torch-made encodings (B4).

    :param enc_xyz: ``(n_rays * S, xyz_dim)`` positional encodings in
        **ray-major** row order (the reshape of ``(rays, S, feat)``), columns
        as ``core/encoding.py`` lays them out.
    :param enc_dir_ray: ``(n_rays, dir_dim)`` per-ray view-dir encodings (NOT
        broadcast over samples), or None for xyz-only nets.
    :param z_values: ``(n_rays, S)``.
    :return: ``(rgb (n_rays, 3), weights (n_rays, S))`` float32. Differentiable
        w.r.t. ``params``, ``enc_xyz``, ``enc_dir_ray`` and ``z_values`` (the z
        gradient covers the compositing's sample spacings; the points' share
        flows through ``enc_xyz``'s gradient into the encoding's backward).
    """
    encd, z = _encoding_inputs(config, enc_dir_ray, z_values)
    return FusedMLPComposited.apply(config, compute_dtype, enc_xyz, encd, z,
                                    *mlp_leaves(params, config))


def apply_mlp_loss_composited(params: Params, config: MLPConfig, enc_xyz: torch.Tensor,
                              enc_dir_ray: Optional[torch.Tensor], z_values: torch.Tensor,
                              ray_dirs3: torch.Tensor, target_rgb: torch.Tensor,
                              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Fused fine-pass objective ``MSE(composite(MLP(enc)), target)`` (B5): one
    kernel runs the forward, the compositing, the MSE cotangent and the whole
    backward with the activations kept (no recompute).

    :param enc_xyz: ``(n_rays * S, xyz_dim)`` ray-major xyz encodings.
    :param enc_dir_ray: ``(n_rays, dir_dim)`` per-ray view-dir encodings.
    :param z_values: ``(n_rays, S)``.
    :param ray_dirs3: ``(n_rays, >=3)`` unnormalised ray directions (d pts / d z).
    :param target_rgb: ``(n_rays, 3)``.
    :return: scalar float32 MSE. Differentiable w.r.t. ``params`` and
        ``z_values`` (the total dz: compositing plus points). ``enc_xyz``,
        ``enc_dir_ray``, ``ray_dirs3`` and ``target_rgb`` get structural-zero
        cotangents: the encodings' path is folded into dz, so do not
        differentiate w.r.t. rays or targets through this function.
    """
    encd, z = _encoding_inputs(config, enc_dir_ray, z_values)
    return FusedMLPLossComposited.apply(config, compute_dtype, enc_xyz, encd, z,
                                        ray_dirs3[:, :3], target_rgb,
                                        *mlp_leaves(params, config))
