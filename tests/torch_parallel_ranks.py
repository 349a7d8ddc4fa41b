"""The rank side of tests/test_torch_parallel.py (and of the distributed
gradient check in tests/test_torch_smoke_references.py): functions that spawned gloo
ranks run (``parallel.mesh.spawn`` imports them by name, so this module
imports nothing of JAX). Each reads its inputs from a ``torch.save`` file and
rank 0 writes what the test compares."""

from __future__ import annotations

import dataclasses

import torch

from nerf_and_dietnerf_tpu_torch.models import nerf
from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib, render_tiles
from nerf_and_dietnerf_tpu_torch.train import train_step as ts


def _frame(result, z):
    return {"rgb": result.rgb, "weights": result.weights, "z": z,
            **{f: getattr(result, f) for f in ("cumprod", "alpha", "sample_rgb")
               if getattr(result, f) is not None}}


def renders_and_grads(rank: int, mesh, inputs_path: str, out_path: str) -> None:
    """Every case of the test file, on this rank: the tile-sharded renders
    (``render_image_sharded`` and ``render_frame``) and each setting's
    fixed-z loss on this rank's rows with the gradient all-reduce and one
    Adam update."""
    cases = torch.load(inputs_path, weights_only=False)
    out = {"renders": {}, "grads": {}}
    for name, c in cases["renders"].items():
        key = None if c["seed"] is None else torch.Generator().manual_seed(c["seed"])
        fn = render_tiles.render_frame if c["via_frame"] else render_tiles.render_image_sharded
        result, z = fn(c["params"], c["config"], mesh, key, c["c2w"], c["fov"], c["h"], c["w"],
                       chunk_size=c["chunk"], diagnostics=c["diagnostics"])
        out["renders"][name] = _frame(result, z)
    for name, c in cases["grads"].items():
        config = dataclasses.replace(c["config"], mesh=mesh)
        lo, hi = mesh_lib.batch_rows(c["orig"].shape[0], mesh.rank, mesh.world_size)
        rows = [t[lo:hi] for t in (c["orig"], c["dirs"], c["rgb"], c["z_c"], c["z_f"])]
        loss, _, grads = ts.loss_and_grads(
            c["params"], lambda p: (nerf.training_losses_fixed_z(p, config, *rows), None))
        grads, scalars = ts.reduce_over_group(grads, {"loss": loss}, mesh)
        opt = ts.Adam(learning_rate=5e-3)
        updates, _ = opt.update(grads, opt.init(c["params"]))
        out["grads"][name] = {"loss": scalars["loss"], "grads": grads,
                              "params": ts.apply_updates(c["params"], updates)}
    if rank == 0:
        torch.save(out, out_path)


def smoke_dist_grads(rank: int, mesh, out_path: str, run_fields: dict, scene: dict) -> None:
    """``chip_smoke._dist_grads`` on this rank with its flagship run and
    scene cut down (``run_fields``, ``scene``); rank 0 writes it beside the
    gradients of the same run's single-device epoch (``make_epoch_fn`` over
    ``DIST_HELD_STEPS`` batches), computed in the same process."""
    from unittest import mock

    import chip_smoke
    from nerf_and_dietnerf_tpu_torch.data import loaders, pipeline
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

    seed = 3
    run = dataclasses.replace(chip_smoke._flagship_run("pallas", "float32"), **run_fields)
    ds = chip_smoke.synthetic_scene(**scene)
    with mock.patch.object(chip_smoke, "_flagship_run", lambda *a: run), \
            mock.patch.object(chip_smoke, "synthetic_scene", lambda: ds):
        out = chip_smoke._dist_grads(torch, torch.device("cpu"), mesh, seed)
    if rank != 0:
        return
    recorded = []

    class Recording(ts.Adam):
        def update(self, grads, opt_state):
            recorded.append([g.detach().clone() for g in tree_leaves(grads)])
            return super().update(grads, opt_state)

    cfg = dataclasses.replace(dataclasses.replace(run, init_seed=seed).nerf_config(),
                              near=ds.near, far=ds.far)
    optimizer = Recording(run.optimizer_lr)
    state = ts.init_train_state(torch.Generator().manual_seed(seed), cfg, optimizer)
    idx = loaders.train_test_split_indices(len(ds), run.test_img_idx, None)
    data = pipeline.RayDataset(ds.images[idx], ds.camera_poses[idx], ds.field_of_view,
                               run.n_rays_in_batch_train)
    tables = [torch.as_tensor(a) for a in (data.origins, data.directions, data.rgb)]
    ts.make_epoch_fn(cfg, optimizer, chip_smoke.DIST_HELD_STEPS, data.batch_size)(
        state, torch.Generator().manual_seed(seed + 21), *tables)
    torch.save(dict(out, epoch=recorded), out_path)
