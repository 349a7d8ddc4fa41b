"""Tile-sharded full-frame rendering: one frame's rays split across the ranks.

Port of ``nerf_and_dietnerf_tpu/parallel/render_tiles.py``. Each chunk of the
frame's rays is split into equal row tiles, one a rank; each rank renders its
tile through ``models/nerf.render`` (the kernels run on the rank's rows), and
the frame is put together by one ``all_reduce`` (sum) of a zero-filled
full-frame buffer into which each rank wrote its tiles: a sum with zeros is
exact, and it runs under NCCL and gloo alike. The buffer is kept on the group
per frame shape (``DataGroup.buffers``) and set up once, not once a frame.

RNG contract: chunking, padding and the generator's draws mirror
``models/nerf.render_image``: every rank draws each chunk's uniforms at the
chunk's full shape, in ``nerf.render``'s order, and keeps its tile's rows,
so a sharded frame with the same generator and the same chunk size is the
single-device frame. The only deviation, as in the JAX package: the chunk
size is rounded up to a multiple of the world size so every rank gets an
equal tile.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nerf_and_dietnerf_tpu_torch.core import cameras, sampling
from nerf_and_dietnerf_tpu_torch.core.rendering import RenderResult
from nerf_and_dietnerf_tpu_torch.models import nerf
from nerf_and_dietnerf_tpu_torch.models.nerf import NeRFConfig
from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib
from nerf_and_dietnerf_tpu_torch.parallel.mesh import DataGroup

# The RenderResult fields a frame may carry, besides z.
_FIELDS = ("rgb", "weights", "cumprod", "alpha", "sample_rgb")


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _chunk_draws(key, config: NeRFConfig, params, chunk: int, n_c: int, n_f: int, device):
    """What ``nerf.render`` draws from ``key`` for a chunk of ``chunk`` rays,
    in its order: the stratified uniforms, then (with a fine pass) the sorted
    resampling uniforms. None in the deterministic mode."""
    if key is None:
        return None
    draws = {"strat_u": torch.rand((chunk, n_c), generator=key, device=device)}
    if params.get("fine") is not None and n_f > 0:
        draws["fine_u"] = sampling.sorted_uniforms(key, (chunk,), n_f, device=device)
    return draws


@torch.no_grad()
def render_image_sharded(params, config: NeRFConfig, mesh: DataGroup, key, c2w, field_of_view,
                         height: int, width: int, chunk_size: int = 16384,
                         n_samples_coarse: Optional[int] = None,
                         n_samples_fine: Optional[int] = None,
                         diagnostics: bool = True) -> Tuple[RenderResult, torch.Tensor]:
    """Full-frame render with each chunk's rays split over the ranks of
    ``mesh``, on ``mesh.device``; every rank returns the whole frame.

    Drop-in replacement for :func:`models.nerf.render_image` on group runs:
    same ``(RenderResult (h, w, ...), z (h, w, S))`` return (tensors of the
    caller's own), same chunk and generator schedule.

    :param key: ``torch.Generator`` on ``mesh.device`` (in the same state on
        every rank) or None (deterministic).
    :param chunk_size: rays per chunk **across the group** (each rank renders
        ``chunk / world_size``), rounded up to a multiple of the world size.
    """
    dev = mesh.device
    n_c = n_samples_coarse or config.n_samples_coarse
    n_f = n_samples_fine or config.n_samples_fine
    orig, dirs = cameras.rays_for_image(
        height, width, field_of_view, torch.as_tensor(c2w, dtype=torch.float32, device=dev))
    n_rays = orig.shape[0]
    chunk = _round_up(min(chunk_size, n_rays), mesh.world_size)
    n_chunks = -(-n_rays // chunk)
    pad = n_chunks * chunk - n_rays
    if pad:
        orig = torch.cat([orig, orig[-1:].expand(pad, 4)], dim=0)
        dirs = torch.cat([dirs, dirs[-1:].expand(pad, 4)], dim=0)
    lo, hi = mesh_lib.batch_rows(chunk, mesh.rank, mesh.world_size)

    buf = frame = None  # the group's buffer and a (n_chunks * chunk, ...) view a field
    for i in range(n_chunks):
        draws = _chunk_draws(key, config, params, chunk, n_c, n_f, dev)
        rows = slice(i * chunk + lo, i * chunk + hi)
        result, z = nerf.render(
            params, config, None, orig[rows], dirs[rows], n_c, n_f, diagnostics=diagnostics,
            draws=None if draws is None else {k: v[lo:hi] for k, v in draws.items()})
        parts = {f: getattr(result, f) for f in _FIELDS if getattr(result, f) is not None}
        parts["z"] = z
        if frame is None:
            buf, frame = _frame_views(mesh, parts, n_chunks * chunk)
        for name, value in parts.items():
            frame[name][rows] = value
    mesh_lib.all_reduce_sum_(buf, mesh)

    def out(name, shape):
        if name not in frame:
            return None
        return frame[name][:n_rays].reshape(height, width, *shape).clone()

    return (
        RenderResult(rgb=out("rgb", (3,)), weights=out("weights", (-1,)),
                     cumprod=out("cumprod", (-1,)), alpha=out("alpha", (-1,)),
                     sample_rgb=out("sample_rgb", (-1, 3))),
        out("z", (-1,)),
    )


def _frame_views(mesh: DataGroup, parts, n_rows: int):
    """Zero the group's f32 buffer for a frame of ``n_rows`` rays with the
    fields of ``parts`` (allocated at the first frame of that shape); return
    it and a ``(n_rows, ...)`` view of it per field."""
    shapes = {name: (n_rows, *v.shape[1:]) for name, v in parts.items()}
    key = tuple(shapes.items())
    buf = mesh.buffers.get(key)
    if buf is None:
        n = sum(torch.Size(s).numel() for s in shapes.values())
        buf = mesh.buffers[key] = torch.empty(n, dtype=torch.float32, device=mesh.device)
    buf.zero_()
    views, at = {}, 0
    for name, shape in shapes.items():
        n = torch.Size(shape).numel()
        views[name] = buf[at:at + n].view(shape)
        at += n
    return buf, views


def render_frame(params, config: NeRFConfig, mesh: Optional[DataGroup], key, c2w,
                 field_of_view, height: int, width: int, chunk_size: int = 16384,
                 n_samples_coarse: Optional[int] = None, n_samples_fine: Optional[int] = None,
                 diagnostics: bool = True, device=None) -> Tuple[RenderResult, torch.Tensor]:
    """Group-aware frame render: tile-sharded over ``mesh`` when it holds
    more than one rank, ``nerf.render_image`` on ``device`` otherwise. The one
    routing point of the eval and offline renders (epoch PSNRs, videos,
    plots)."""
    if mesh is not None and mesh.world_size > 1:
        return render_image_sharded(
            params, config, mesh, key, c2w, field_of_view, height, width,
            chunk_size=chunk_size, n_samples_coarse=n_samples_coarse,
            n_samples_fine=n_samples_fine, diagnostics=diagnostics)
    return nerf.render_image(
        params, config, key, c2w, field_of_view, height, width, chunk_size=chunk_size,
        n_samples_coarse=n_samples_coarse, n_samples_fine=n_samples_fine,
        diagnostics=diagnostics, device=device)
