"""One rank of a multi-process training drill over ``torch.distributed``.

The port's counterpart of the root ``tools/multiprocess_worker.py`` (which
drives the JAX package): the ``Trainer`` (or, with ``--diet``, the
``DietTrainer``) on a synthetic scene made from a seed, over the process group
of the launcher's variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``; without them, one process and no group). It exercises the
per-rank ray slices, the gradient all-reduce, the tile-sharded eval renders,
rank 0's artifacts and save-directory name, and a resume by fresh processes.

Each rank writes ``result_rank{i}.json`` (``result_sp.json`` without a group;
``_from{N}`` added on a resume from epoch N) into ``--out``: its per-epoch
losses, PSNRs and seconds, its parameters' fingerprint and digest, its
kernels' launch counts and the save directory.

Usage (one command a rank)::

    RANK=0 WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
        python -m nerf_and_dietnerf_tpu_torch.tools.multiprocess_worker --out DIR \\
        --epochs 2 [--start-epoch 2 --save-dir NAME] [--diet tiny] \\
        [--backend gloo] [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True, help="shared artifact directory")
    p.add_argument("--epochs", type=int, default=2, help="train through this epoch")
    p.add_argument("--start-epoch", type=int, default=-1,
                   help=">= 0: resume the --save-dir run from this epoch's checkpoint")
    p.add_argument("--save-dir", default=None, help="the save directory's name to resume")
    p.add_argument("--diet", choices=("tiny", "full"), default=None,
                   help="DietTrainer with the tiny embedder and interval 3, or the defaults")
    p.add_argument("--backend", default=None,
                   help="process group backend (default: nccl on a GPU, gloo on the CPU)")
    p.add_argument("--device", default="cpu", help="this rank's device, e.g. cpu or cuda:0")
    p.add_argument("--run", default="{}",
                   help="JSON of RunConfig fields over the tiny defaults")
    p.add_argument("--scene", default=None,
                   help=".npz of images, camera_poses, field_of_view, near, far "
                   "(default: the tiny scene)")
    return p.parse_args(argv)


def tiny_scene():
    """The JAX worker's scene: 5 random 12x12 views, made from seed 0."""
    from nerf_and_dietnerf_tpu_torch.data.loaders import Dataset

    rng = np.random.default_rng(0)
    n, h = 5, 12  # >= 4 views so the slerp pose sampler has 3 train poses
    images = rng.uniform(size=(n, h, h, 3)).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * n)
    poses[:, 2, 3] = 2.0 + 0.2 * np.arange(n)
    poses[:, 0, 3] = 0.1 * np.arange(n)
    return Dataset(images=images, camera_poses=poses, field_of_view=0.8, near=0.5, far=3.0,
                   average_c2w_before_recenter=np.eye(4), scale=1.0)


def load_scene(path):
    from nerf_and_dietnerf_tpu_torch.data.loaders import Dataset

    with np.load(path) as z:
        return Dataset(images=z["images"], camera_poses=z["camera_poses"],
                       field_of_view=float(z["field_of_view"]), near=float(z["near"]),
                       far=float(z["far"]), average_c2w_before_recenter=np.eye(4), scale=1.0)


def tiny_run(args):
    """The JAX worker's RunConfig, with ``--run``'s fields over it."""
    from nerf_and_dietnerf_tpu_torch.utils.config import RunConfig

    fields = dict(
        hidden_layer_dim=16, last_hidden_layer_dim=8, n_pos_enc_dim_xyz=2,
        n_pos_enc_view_dir=2, n_render_samples_coarse=4, n_render_samples_fine=4,
        near_depth_render=0.5, far_depth_render=3.0, n_rays_in_batch_train=64,
        n_rays_in_batch_render=128, n_epochs=args.epochs, test_img_idx=0,
        idx_train_img_to_plot=1, compute_dtype="float32",
        starting_epoch_number=args.start_epoch, general_save_location=args.out,
        existing_save_dir_name=args.save_dir, config_name="shared_run",
    )
    if args.diet:
        fields.update(type_of_model="DietNeRF", allow_random_embedder=True)
    fields.update(json.loads(args.run))
    return RunConfig(**fields)


def make_trainer(args, run, dataset, save_dir, device, mesh):
    from nerf_and_dietnerf_tpu_torch.train.trainer import Trainer

    if not args.diet:
        return Trainer(run, dataset, save_dir, device=device, mesh=mesh)
    from nerf_and_dietnerf_tpu_torch.models import vit
    from nerf_and_dietnerf_tpu_torch.models.dietnerf import DietConfig
    from nerf_and_dietnerf_tpu_torch.train.diet_trainer import DietTrainer

    diet = DietConfig()
    if args.diet == "tiny":
        diet = DietConfig(interval=3, cs_image_size=16, cs_samples=4, cs_chunk_rays=64,
                          vit=vit.ViTConfig(image_size=32, patch_size=16, hidden_dim=32,
                                            n_layers=2, n_heads=4, mlp_dim=64))
    return DietTrainer(run, dataset, save_dir, device=device, diet=diet, mesh=mesh)


def params_digest(params) -> dict:
    """The parameters' float fingerprint (the JAX worker's sum of |leaves|)
    and a digest of their bytes, for bitwise comparisons across ranks."""
    from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

    leaves = [p.detach().float().cpu().numpy() for p in tree_leaves(params)]
    digest = hashlib.sha256()
    for leaf in leaves:
        digest.update(np.ascontiguousarray(leaf).tobytes())
    return {"params_fingerprint": float(sum(float(np.abs(leaf).sum()) for leaf in leaves)),
            "params_sha256": digest.hexdigest()}


def run(args, device, mesh):
    """Train as ``args`` says on ``device`` (a rank of ``mesh`` or alone);
    returns ``(trainer, result)``."""
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib
    from nerf_and_dietnerf_tpu_torch.utils import config as config_lib

    run_config = tiny_run(args)
    dataset = load_scene(args.scene) if args.scene else tiny_scene()
    save_dir = config_lib.make_save_dir(run_config, mesh=mesh)
    trainer = make_trainer(args, run_config, dataset, save_dir, device, mesh)
    if args.start_epoch >= 0 and trainer.start_epoch != args.start_epoch:
        raise RuntimeError(f"resumed at epoch {trainer.start_epoch}, not {args.start_epoch}")
    kernel_lib.reset_launch_counts()
    history = trainer.fit(log=None)
    result = {
        "rank": 0 if mesh is None else mesh.rank,
        "world_size": 1 if mesh is None else mesh.world_size,
        "device": str(device),
        "epochs": [s.epoch for s in history],
        "losses": [s.loss for s in history],
        "psnr_test": [s.psnr_test for s in history],
        "psnr_train": [s.psnr_train for s in history],
        "seconds": [s.seconds for s in history],
        "steps_per_epoch": trainer.data.batches_per_epoch,
        "rows_per_step": trainer.data.per_host,
        "launches": {k: v for k, v in kernel_lib.LAUNCHES.items() if v},
        "latest_state": trainer.ckpt.latest_step(),
        "save_dir": Path(save_dir).name,
        **params_digest(trainer.state.params),
    }
    return trainer, result


def result_name(args, result) -> str:
    tag = "sp" if result["world_size"] == 1 else f"rank{result['rank']}"
    phase = f"_from{args.start_epoch}" if args.start_epoch >= 0 else ""
    return f"result_{tag}{phase}.json"


def main(argv=None) -> int:
    args = parse_args(argv)
    from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib

    device, mesh = torch.device(args.device), None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = mesh_lib.init_distributed(args.device, args.backend)
        mesh = mesh_lib.make_mesh(device)
    try:
        _, result = run(args, device, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    with open(Path(args.out) / result_name(args, result), "w") as f:
        json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
