"""NeRF model: coarse/fine rendering and the training objective.

Port of ``nerf_and_dietnerf_tpu/models/nerf.py``: functions over a parameter
tree ``{"coarse": mlp_params, "fine": mlp_params | None}`` and a frozen
config. As there, training and rendering differ:

- training: stratified coarse z; coarse MSE; fine z = **only** the
  ``n_fine`` values resampled from the coarse weights (inside the
  differentiated region); fine MSE; loss = sum;
- rendering: the fine pass sees the resampled z merged with the coarse z
  (``n_coarse + n_fine`` samples).

Randomness comes from a ``torch.Generator`` (``key``) or is injected
(``draws``) so tests can feed the JAX package's numbers; ``key=None`` is the
deterministic mode.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from nerf_and_dietnerf_tpu_torch.core import cameras, encoding, rendering, sampling
from nerf_and_dietnerf_tpu_torch.core.rendering import RenderResult
from nerf_and_dietnerf_tpu_torch.models import mlp as mlp_lib
from nerf_and_dietnerf_tpu_torch.models.mlp import MLPConfig
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

# The CUDA MLP kernels on torch encodings: B1/B2, B4 with fuse_compositing, B5
# on the fine pass with fuse_fine_loss.
MLP_BACKENDS = ("pallas", "pallas_mlp")
RAYMARCH_BACKENDS = ("pallas_rm",)        # the fused ray-march kernels B6 (B7 with fuse_compositing)
PLAIN_BACKENDS = ("xla",)                 # plain torch ops


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Model + render hyperparameters. ``backend`` takes the JAX package's
    names: "pallas" / "pallas_mlp" select the CUDA MLP kernels on torch-made
    encodings, "pallas_rm" the fused ray-march kernels (points and encodings
    built in the kernel from per-ray data), "xla" plain torch ops.
    ``fuse_compositing`` moves compositing into the kernel on the train path
    ("pallas": the MLP + compositing kernel B4; "pallas_rm": B7; ignored by
    "xla"). ``fuse_fine_loss`` runs the fine pass's whole objective, forward
    and backward, as one kernel (B5) under "pallas" / "pallas_mlp"; the other
    backends accept it and ignore it, as in the JAX package. Neither takes
    density noise."""

    mlp: MLPConfig = MLPConfig()
    n_samples_coarse: int = 64
    n_samples_fine: int = 128   # 0 => no fine network
    near: float = 2.0
    far: float = 6.0
    compute_dtype: Any = torch.bfloat16
    backend: str = "xla"
    stop_fine_z_grad: bool = False
    sigma_noise_std: float = 0.0
    fuse_compositing: bool = False
    fuse_fine_loss: bool = False

    def __post_init__(self):
        if self.backend not in MLP_BACKENDS + RAYMARCH_BACKENDS + PLAIN_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")

    @property
    def has_fine(self) -> bool:
        return self.n_samples_fine > 0


def init_params(generator: torch.Generator, config: NeRFConfig, device="cpu") -> Params:
    """Coarse then fine MLP, drawn in that order from a CPU ``generator``."""
    params: Params = {"coarse": mlp_lib.init_params(generator, config.mlp, device)}
    params["fine"] = (
        mlp_lib.init_params(generator, config.mlp, device) if config.has_fine else None
    )
    return params


def _mlp_apply(config: NeRFConfig):
    if config.backend in MLP_BACKENDS:
        from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda

        return raymarch_cuda.apply_mlp_fused
    return mlp_lib.apply_mlp


def _view_comps(config: NeRFConfig, rays_dirs):
    if not config.mlp.uses_view_dirs:
        return None
    return cameras.view_direction_components(rays_dirs, config.mlp.n_angles)


def _encodings_per_ray(config: NeRFConfig, rays_orig, rays_dirs, z_values):
    """What the MLP + compositing kernels (B4, B5) take: the xyz encodings
    ``(rays * samples, xyz_dim)`` in ray-major rows and the view-dir encodings
    ``(rays, dir_dim)`` per ray, never broadcast to the samples."""
    points = cameras.sample_points_along_rays(rays_orig, rays_dirs, z_values)[..., :3]
    enc_xyz = encoding.encode_xyz(points.reshape(-1, 3), config.mlp.n_freq_xyz)
    enc_dir = None
    if config.mlp.uses_view_dirs:
        enc_dir = encoding.encode_view_dirs(_view_comps(config, rays_dirs), config.mlp.n_freq_dir)
    return enc_xyz, enc_dir


def render_rays(mlp_params: Params, config: NeRFConfig, rays_orig, rays_dirs, z_values,
                sigma_noise=None) -> RenderResult:
    """Evaluate one network along ``z_values`` (rays, samples) and composite.
    The per-ray view-dir encoding is broadcast to every sample."""
    n_rays, n_samples = z_values.shape
    if config.backend in RAYMARCH_BACKENDS:
        # Points and encodings are built in the kernel from per-ray data. Its
        # backward gives the rays structural-zero cotangents (dparams and dz
        # are real): right for training and rendering, where rays are data.
        from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda

        raw = research_kernels_cuda.apply_raymarch_fused(
            mlp_params, config.mlp, rays_orig, rays_dirs, _view_comps(config, rays_dirs),
            z_values, config.compute_dtype,
        )
        return rendering.composite(raw, z_values, sigma_noise=sigma_noise)
    enc_xyz, enc_dir = _encodings_per_ray(config, rays_orig, rays_dirs, z_values)
    if enc_dir is not None:
        enc_dir = enc_dir[:, None, :].expand(n_rays, n_samples, enc_dir.shape[-1]).reshape(
            n_rays * n_samples, -1)
    raw = _mlp_apply(config)(
        mlp_params, config.mlp, enc_xyz, enc_dir, compute_dtype=config.compute_dtype
    )
    return rendering.composite(raw.reshape(n_rays, n_samples, 4), z_values,
                               sigma_noise=sigma_noise)


def render_rays_train(mlp_params: Params, config: NeRFConfig, rays_orig, rays_dirs, z_values,
                      noise_key=None, noise=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-path evaluation of one network: ``(rgb, weights)``. With
    ``sigma_noise_std > 0`` the density noise is drawn from ``noise_key`` or
    taken from ``noise`` (standard normals, one per sample). With
    ``fuse_compositing`` this is one kernel, which composites in the kernel
    and takes no noise: B7 under "pallas_rm", B4 on torch-made encodings
    under "pallas" / "pallas_mlp"."""
    sigma_noise = None
    if config.sigma_noise_std > 0.0 and (noise_key is not None or noise is not None):
        if config.fuse_compositing or config.fuse_fine_loss:
            raise ValueError(
                "sigma_noise_std requires the torch compositing path; disable "
                "fuse_compositing / fuse_fine_loss (the fused kernels composite "
                "without a noise input)"
            )
        if noise is None:
            noise = torch.randn(z_values.shape, generator=noise_key, device=z_values.device)
        sigma_noise = config.sigma_noise_std * noise
    if config.backend in RAYMARCH_BACKENDS and config.fuse_compositing:
        from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda

        return research_kernels_cuda.apply_raymarch_composited(
            mlp_params, config.mlp, rays_orig, rays_dirs, _view_comps(config, rays_dirs),
            z_values, config.compute_dtype,
        )
    if config.backend in MLP_BACKENDS and config.fuse_compositing:
        from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda

        enc_xyz, enc_dir = _encodings_per_ray(config, rays_orig, rays_dirs, z_values)
        return research_kernels_cuda.apply_mlp_composited(
            mlp_params, config.mlp, enc_xyz, enc_dir, z_values, config.compute_dtype)
    result = render_rays(mlp_params, config, rays_orig, rays_dirs, z_values,
                         sigma_noise=sigma_noise)
    return result.rgb, result.weights


def render(params: Params, config: NeRFConfig, key, rays_orig, rays_dirs,
           n_samples_coarse: Optional[int] = None, n_samples_fine: Optional[int] = None,
           diagnostics: bool = True, draws: Optional[Dict[str, torch.Tensor]] = None):
    """Render path: coarse pass, then a fine pass over the merged z.

    :param key: ``torch.Generator`` on the rays' device, or None for the
        deterministic mode.
    :param draws: optional injected ``strat_u`` (rays, n_c) uniforms and
        ``fine_u`` (rays, n_f) sorted uniforms.
    :return: ``(result, z_values)``; without ``diagnostics`` only ``rgb`` and
        ``weights`` of the result are set, computed by the train path's
        :func:`render_rays_train` (one fused kernel under "pallas_rm" with
        ``fuse_compositing``).
    """
    draws = draws or {}
    n_c = n_samples_coarse or config.n_samples_coarse
    n_f = n_samples_fine or config.n_samples_fine
    z = sampling.stratified_z_values(key, config.near, config.far, (rays_orig.shape[0],), n_c,
                                     device=rays_orig.device, uniform=draws.get("strat_u"))
    has_fine = params.get("fine") is not None and n_f > 0
    if diagnostics:
        result = render_rays(params["coarse"], config, rays_orig, rays_dirs, z)
        if has_fine:
            z = sampling.merged_fine_z_values(key, result.weights, z, n_f, u=draws.get("fine_u"))
            result = render_rays(params["fine"], config, rays_orig, rays_dirs, z)
        return result, z
    rgb, weights = render_rays_train(params["coarse"], config, rays_orig, rays_dirs, z)
    if has_fine:
        z = sampling.merged_fine_z_values(key, weights, z, n_f, u=draws.get("fine_u"))
        rgb, weights = render_rays_train(params["fine"], config, rays_orig, rays_dirs, z)
    return RenderResult(rgb, weights, None, None, None), z


def _fine_mse(params_fine, config, rays_orig, rays_dirs, z_fine, target_rgb, noise_key=None,
              noise=None):
    """Fine-pass MSE over the given z. With ``fuse_fine_loss`` under "pallas" /
    "pallas_mlp" it is one kernel (B5), which returns the total dz itself and
    gives the encodings structural-zero cotangents: they are built outside
    the graph."""
    if config.backend in MLP_BACKENDS and config.fuse_fine_loss:
        from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda

        with torch.no_grad():
            enc_xyz, enc_dir = _encodings_per_ray(config, rays_orig, rays_dirs, z_fine)
        return research_kernels_cuda.apply_mlp_loss_composited(
            params_fine, config.mlp, enc_xyz, enc_dir, z_fine, rays_dirs, target_rgb,
            config.compute_dtype)
    rgb_fine, _ = render_rays_train(params_fine, config, rays_orig, rays_dirs, z_fine,
                                    noise_key=noise_key, noise=noise)
    return torch.mean(torch.square(target_rgb - rgb_fine))


def training_losses(params: Params, config: NeRFConfig, key, rays_orig, rays_dirs, target_rgb,
                    draws: Optional[Dict[str, torch.Tensor]] = None):
    """Coarse MSE + fine MSE (fine over the resampled z only).

    :param key: ``torch.Generator`` on the rays' device. Draw order: coarse
        jitter, resampling exponentials, then (with ``sigma_noise_std > 0``)
        coarse and fine density noise.
    :param draws: optional injected ``strat_u``, ``fine_u``, ``noise_coarse``,
        ``noise_fine``.
    :return: ``(loss, metrics)`` with ``loss`` / ``psnr_coarse`` / ``psnr_fine``.
    """
    draws = draws or {}
    noise_on = config.sigma_noise_std > 0.0
    z = sampling.stratified_z_values(key, config.near, config.far, (rays_orig.shape[0],),
                                     config.n_samples_coarse, device=rays_orig.device,
                                     uniform=draws.get("strat_u"))
    rgb_coarse, weights_coarse = render_rays_train(
        params["coarse"], config, rays_orig, rays_dirs, z,
        noise_key=key if noise_on else None, noise=draws.get("noise_coarse"),
    )
    mse_coarse = torch.mean(torch.square(target_rgb - rgb_coarse))
    loss = mse_coarse
    metrics = {"psnr_coarse": rendering.psnr_from_mse(mse_coarse.detach())}
    if params.get("fine") is not None:
        z_fine = sampling.resample_z_from_weights(key, weights_coarse, z, config.n_samples_fine,
                                                  u=draws.get("fine_u"))
        if config.stop_fine_z_grad:
            z_fine = z_fine.detach()
        mse_fine = _fine_mse(params["fine"], config, rays_orig, rays_dirs, z_fine, target_rgb,
                             noise_key=key if noise_on else None, noise=draws.get("noise_fine"))
        loss = loss + mse_fine
        metrics["psnr_fine"] = rendering.psnr_from_mse(mse_fine.detach())
    metrics["loss"] = loss.detach()
    return loss, metrics


def training_losses_fixed_z(params: Params, config: NeRFConfig, rays_orig, rays_dirs,
                            target_rgb, z_coarse, z_fine):
    """The training objective with caller-supplied z (no RNG, no resampling in
    the differentiated region): a smooth function of the parameters, so two
    implementations compare to float tolerance."""
    rgb_coarse, _ = render_rays_train(params["coarse"], config, rays_orig, rays_dirs, z_coarse)
    loss = torch.mean(torch.square(target_rgb - rgb_coarse))
    if params.get("fine") is not None and z_fine is not None:
        loss = loss + _fine_mse(params["fine"], config, rays_orig, rays_dirs, z_fine, target_rgb)
    return loss


@torch.no_grad()
def render_image(params: Params, config: NeRFConfig, key, c2w, field_of_view, height: int,
                 width: int, chunk_size: int = 16384, n_samples_coarse: Optional[int] = None,
                 n_samples_fine: Optional[int] = None, diagnostics: bool = True, device=None):
    """Full-frame render, chunked over rays. Every chunk has the same size: the
    ray list is padded with copies of the last ray, as in the JAX package.

    :param key: ``torch.Generator`` on ``device`` or None (deterministic).
    :param device: where to render; the GPU unless ``device="cpu"`` is given.
    :return: ``(RenderResult with (h, w, ...) shapes, z_values (h, w, S))``.
    """
    dev = resolve_device(device)
    orig, dirs = cameras.rays_for_image(
        height, width, field_of_view, torch.as_tensor(c2w, dtype=torch.float32, device=dev))
    n_rays = orig.shape[0]
    chunk = min(chunk_size, n_rays)
    n_chunks = -(-n_rays // chunk)
    pad = n_chunks * chunk - n_rays
    if pad:
        orig = torch.cat([orig, orig[-1:].expand(pad, 4)], dim=0)
        dirs = torch.cat([dirs, dirs[-1:].expand(pad, 4)], dim=0)
    parts = [
        render(params, config, key, orig[i * chunk:(i + 1) * chunk],
               dirs[i * chunk:(i + 1) * chunk], n_samples_coarse, n_samples_fine,
               diagnostics=diagnostics)
        for i in range(n_chunks)
    ]

    def cat(field, shape):
        vals = [getattr(p[0], field) for p in parts]
        if vals[0] is None:
            return None
        return torch.cat(vals, dim=0)[:n_rays].reshape(height, width, *shape)

    z = torch.cat([p[1] for p in parts], dim=0)[:n_rays]
    return (
        RenderResult(rgb=cat("rgb", (3,)), weights=cat("weights", (-1,)),
                     cumprod=cat("cumprod", (-1,)), alpha=cat("alpha", (-1,)),
                     sample_rgb=cat("sample_rgb", (-1, 3))),
        z.reshape(height, width, -1),
    )
