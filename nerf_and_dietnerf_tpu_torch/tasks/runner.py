"""The execution runner: one YAML config -> dataset, training, videos, plots.

Port of ``nerf_and_dietnerf_tpu/tasks/runner.py`` (the reference's
``ExecutionRun``, ``src/ExecutionRun.py:53-152``): loads config + dataset at
construction, then ``start()`` executes the enabled tasks in the reference's
fixed order with a cloud backup after each. The training task drives the
port's :class:`Trainer`, or its :class:`DietTrainer` for DietNeRF configs;
the rendering tasks render each frame with ``render_tiles.render_frame`` on
the runner's device (tile-sharded over a data-parallel group: every rank
renders every frame, rank 0 alone writes the files). Randomness follows the
JAX package's keys as generator seeds: video frame ``i`` uses seed ``i``,
interpolation frame ``i`` seed ``100 + i``, the ray-value render seed 0.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerf_and_dietnerf_tpu_torch.core import pose_math
from nerf_and_dietnerf_tpu_torch.data import loaders
from nerf_and_dietnerf_tpu_torch.parallel import render_tiles
from nerf_and_dietnerf_tpu_torch.train import checkpoint
from nerf_and_dietnerf_tpu_torch.train.diet_trainer import DietTrainer, check_embedder
from nerf_and_dietnerf_tpu_torch.train.trainer import Trainer
from nerf_and_dietnerf_tpu_torch.utils import config as config_lib
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device
from nerf_and_dietnerf_tpu_torch.viz import image_ops, plots, video

VIDEOS_DIRNAME = "video_save"  # reference src/ExecutionRun.py:43


class Runner:
    """One execution of one config file (reference ``ExecutionRun``).

    :param config_path: the run's YAML file.
    :param vit_weights: ViT weights for DietNeRF configs (``models/vit.py``
        ``load_pretrained`` formats).
    :param save_root: overrides ``general_save_location``.
    :param device: where to train and render; the GPU unless ``device="cpu"``
        is given.
    :param mesh: the ``parallel.mesh.DataGroup`` this process is a rank of;
        None trains and renders on one device. ``main`` builds the group,
        from its flags or the config's ``mesh: data_devices``.
    """

    def __init__(self, config_path, vit_weights: Optional[str] = None,
                 save_root: Optional[str] = None, device=None, mesh=None):
        self.config_path = Path(config_path)
        self.run = config_lib.load_config(self.config_path)
        if save_root is not None:
            self.run.general_save_location = save_root
        # Refuse, before any file is written, a DietNeRF run without an
        # embedder (the DietTrainer would).
        if self.run.is_dietnerf:
            check_embedder(self.run, vit_weights)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.writes = mesh is None or mesh.rank == 0  # rank 0 alone writes files
        self.vit_weights = vit_weights

        self.dataset = loaders.load_dataset(
            self.run.dataset_type,
            self.run.dataset_location,
            near=self.run.near_depth_render,
            far=self.run.far_depth_render,
        )
        # The loaders rescale near/far while spherifying; the model uses the
        # rescaled bounds (reference src/ExecutionRun.py:104-113).
        self.nerf_config = dataclasses.replace(
            self.run.nerf_config(), near=self.dataset.near, far=self.dataset.far)
        # All offline rendering (videos, plots) runs in float32, through the
        # config's backend, with the train-path fusions off (as in JAX).
        self.render_config = dataclasses.replace(
            self.nerf_config, compute_dtype=torch.float32, fuse_compositing=False,
            fuse_fine_loss=False)
        self.save_dir = config_lib.make_save_dir(self.run, self.config_path, mesh=self.mesh)
        self.epoch_number = max(self.run.starting_epoch_number, 0)
        self.datetime_start = time.strftime("%Y-%m-%d_%H-%M-%S")
        self._params = None

    # ------------------------------------------------------------------ #
    # Task dispatch (reference src/ExecutionRun.py:115-152)               #
    # ------------------------------------------------------------------ #

    def start(self) -> None:
        t = self.run.tasks
        # Rank 0 alone backs up the files it wrote.
        backup = self.backup_to_gcp if self.writes else (lambda: None)
        if t.start_training:
            self.training()
            self.epoch_number = self.run.n_epochs
            backup()
        if t.render_and_save_test_left_to_right_video:
            self.render_video(
                self.l_to_r_path_matrices(),
                video.FILENAME_RGB_L_TO_R, video.FILENAME_DEPTH_L_TO_R,
            )
            backup()
        if t.render_and_save_test_sphere_video:
            self.render_video(
                self.sphere_path_matrices(),
                video.FILENAME_RGB_SPHERE, video.FILENAME_DEPTH_SPHERE,
            )
            backup()
        if t.render_and_save_test_path_video:
            self.render_video(
                self.waypoint_path_matrices(),
                video.FILENAME_RGB_PATH, video.FILENAME_DEPTH_PATH,
            )
            backup()
        if t.save_dataset_video:
            self.save_dataset_video()
            backup()
        if t.save_plots_video:
            self.save_plot_video()
            backup()
        if t.create_plots_that_visualize_values_along_rays:
            self.create_ray_value_plots()
            backup()
        if t.create_plot_that_visualize_rendering_between_2_images:
            self.create_interpolation_plot()
            backup()
        backup()

    # ------------------------------------------------------------------ #
    # Training                                                            #
    # ------------------------------------------------------------------ #

    def _make_trainer(self) -> Trainer:
        if self.run.is_dietnerf:
            return DietTrainer(self.run, self.dataset, self.save_dir, device=self.device,
                               epoch_callback=self._epoch_callback,
                               vit_weights=self.vit_weights, mesh=self.mesh)
        return Trainer(self.run, self.dataset, self.save_dir, device=self.device,
                       epoch_callback=self._epoch_callback, mesh=self.mesh)

    def training(self) -> None:
        trainer = self._make_trainer()
        # Snapshot the held-out test view at training start
        # (reference src/ExecutionRun.py:177).
        if self.writes:
            plots.save_test_image(self.save_dir, self.dataset.images[self.run.test_img_idx])
        trainer.fit(log=print if self.writes else None)
        self._params = trainer.state.params

    def _epoch_callback(self, trainer: Trainer, stats) -> None:
        """Per-epoch plot + cloud backup (reference src/ExecutionRun.py:193-201).
        Every rank takes the eval renders, which are collectives over a
        group; rank 0 alone writes."""
        renders = trainer.render_eval_images(stats.epoch)
        if not self.writes:
            return
        train_idx, train_render = renders["train"]
        test_idx, test_render = renders["test"]
        plots.save_epoch_plot(
            self.save_dir, stats.epoch,
            self.dataset.images[train_idx], train_render,
            self.dataset.images[test_idx], test_render,
            trainer.psnrs_train, trainer.psnrs_test,
        )
        print(
            f" - Entire epoch {stats.epoch}# took {stats.seconds:.5g} seconds, "
            f"with average iteration time "
            f"{stats.seconds / max(1, trainer.data.batches_per_epoch):.3g}. "
            f"The test PSNR was: {stats.psnr_test:.5g}"
        )
        self.backup_to_gcp()

    # ------------------------------------------------------------------ #
    # Rendering params (load the epoch checkpoint like the reference's    #
    # fresh get_nerf per task, src/ExecutionRun.py:216-232)               #
    # ------------------------------------------------------------------ #

    def load_params(self):
        if self._params is not None:
            return self._params
        h5 = checkpoint.nerf_h5_path(self.save_dir, self.epoch_number)
        if not h5.exists():
            raise FileNotFoundError(
                f"no trained weights at {h5}; run training first or point "
                "existing_save_dir_name/starting_epoch_number at a checkpoint"
            )
        self._params = checkpoint.load_keras_h5(
            h5, self.nerf_config.mlp, has_fine=self.nerf_config.has_fine, device=self.device)
        return self._params

    # ------------------------------------------------------------------ #
    # Video camera paths (reference src/ExecutionRun.py:358-440)          #
    # ------------------------------------------------------------------ #

    def l_to_r_path_matrices(self) -> np.ndarray:
        seconds = 5
        total = self.run.video.fps_render_video * seconds
        mats = pose_math.l_to_r_c2w_matrices(total)
        poi, is_spherical = pose_math.estimate_point_of_interest(
            self.dataset.camera_poses
        )
        if is_spherical:
            test_pose = self.dataset.camera_poses[self.run.test_img_idx]
            mats[:, :3, 3] = test_pose[:3, 3] - mats[:, :3, 3]
            mats[:, :3, :3] = test_pose[:3, :3]
            return mats
        avg = pose_math.to_homogeneous(
            pose_math.poses_average(self.dataset.camera_poses)[None, :, :4]
        )[0]
        return avg @ mats

    def sphere_path_matrices(self) -> np.ndarray:
        seconds = 6
        total = int(self.run.video.fps_render_video * seconds)
        mats = pose_math.sphere_orbit_c2w_matrices(total)
        poi, is_spherical = pose_math.estimate_point_of_interest(
            self.dataset.camera_poses
        )
        if is_spherical:
            test_rot = self.dataset.camera_poses[self.run.test_img_idx][:3, :3]
            rot = pose_math.rotation_matrix_source_to_dest(mats[0, :3, :3], test_rot)
            mats = rot @ mats
            mats[:, :3, 3] += poi
        elif self.run.dataset_type == "blender":
            # Blender l_to_r scenes recentred z away; restore the original
            # camera distance (reference src/ExecutionRun.py:403-411).
            scale = self.dataset.scale
            distance = self.dataset.average_c2w_before_recenter[2, 3]
            mats[:, :3, 3] *= scale * distance
            mats[:, :3, 3] += np.asarray([0.0, 0.0, -scale * distance])
        return mats

    def waypoint_path_matrices(self) -> np.ndarray:
        seconds = 2
        total = int(self.run.video.fps_render_video * seconds)
        indices = self.run.video.img_indices_for_path_video
        if not indices:
            raise ValueError("img_indices_for_path_video is empty")
        c2ws = self.dataset.camera_poses[np.asarray(indices)]
        return pose_math.multi_waypoint_path(c2ws, total)

    # ------------------------------------------------------------------ #
    # Render + save videos                                                #
    # ------------------------------------------------------------------ #

    def _render_frame(self, params, key, c2w, diagnostics=False):
        """One full-frame offline render on the runner's device, tile-sharded
        over the group when there is one."""
        ds = self.dataset
        return render_tiles.render_frame(
            params, self.render_config, self.mesh, key, np.asarray(c2w, np.float32),
            ds.field_of_view, ds.height, ds.width,
            chunk_size=self.run.offline_chunk_size(), diagnostics=diagnostics,
            device=self.device,
        )

    def _key(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def render_video(self, c2w_matrices, filename_rgb, filename_depths, loops=1):
        """Per-frame full renders -> rgb video + histogram-equalized
        expected-depth video (reference ``src/ExecutionRun.py:315-356``). The
        depth is reduced on the device: only rgb and depth reach the host."""
        params = self.load_params()
        rgb_frames, depth_frames = [], []
        for i, c2w in enumerate(c2w_matrices):
            result, z = self._render_frame(params, self._key(i), c2w)
            rgb_frames.append(result.rgb.cpu().numpy())
            depth = (result.weights * z).sum(dim=-1).cpu().numpy()
            depth_frames.append(image_ops.histogram_equalize(depth)[0])
            if i % 30 == 0 and self.writes:
                print(f"rendered frame {i + 1}/{len(c2w_matrices)}")
        if not self.writes:
            return
        out_dir = self.save_dir / VIDEOS_DIRNAME
        fps = self.run.video.fps_render_video
        video.save_frames_as_video(out_dir / filename_rgb, rgb_frames * loops, fps)
        video.save_frames_as_video(out_dir / filename_depths, depth_frames * loops, fps)

    def save_dataset_video(self) -> None:
        """All training images as a video (reference src/ExecutionRun.py:442-449)."""
        if not self.writes:
            return
        train_idx = loaders.train_test_split_indices(
            len(self.dataset), self.run.test_img_idx,
            self.run.pics_indices_to_use_in_dataset,
        )
        video.save_frames_as_video(
            self.save_dir / VIDEOS_DIRNAME / video.FILENAME_TRAIN_SET,
            self.dataset.images[train_idx],
            self.run.video.fps_train_set_video,
        )

    def save_plot_video(self) -> None:
        if not self.writes:
            return
        plots_dir = self.save_dir / plots.PLOT_ITERATION_DIRNAME
        if not plots_dir.is_dir():
            print(f"Could not find: {plots_dir}\nSo didn't create the plot video.")
            return
        video.save_plot_video(
            self.run.video.fps_plot_video,
            plots_dir,
            self.save_dir / VIDEOS_DIRNAME / video.FILENAME_PLOTS,
        )

    # ------------------------------------------------------------------ #
    # Special plots                                                       #
    # ------------------------------------------------------------------ #

    def create_ray_value_plots(self) -> None:
        """Diagnostic per-ray compositing plots for 3 chosen pixels
        (reference ``src/ExecutionRun.py:478-508``)."""
        params = self.load_params()
        ds = self.dataset
        c2w = ds.camera_poses[self.run.idx_train_img_to_plot]
        result, z = self._render_frame(params, self._key(0), c2w, diagnostics=True)
        h, w = ds.height, ds.width
        coords = np.asarray(((h // 2, w // 2), (h // 4, w // 4), (h // 4, w // 2)))
        alpha, cumprod, sample_rgb, weights, z_sel = plots.slice_out_rays(
            coords, *(t.cpu().numpy() for t in (
                result.alpha, result.cumprod, result.sample_rgb, result.weights, z)),
        )
        if not self.writes:
            return
        alpha_b, cum_b, rgb_b, w_b, _ = plots.rebin_ray_samples(
            self.run.n_render_samples_coarse, z_sel, weights, cumprod, alpha, sample_rgb
        )
        plots.save_ray_value_plots(
            self.save_dir, result.rgb.cpu().numpy(), coords,
            w_b, cum_b, alpha_b, rgb_b, self.epoch_number,
        )

    def create_interpolation_plot(self) -> None:
        """Renders along the slerp between two adjacent dataset views
        (reference ``src/ExecutionRun.py:510-538``)."""
        params = self.load_params()
        ds = self.dataset
        idx2 = self.run.idx_train_img_to_plot
        idx1, idx2 = (0, 1) if idx2 == 0 else (idx2 - 1, idx2)
        path = pose_math.c2w_path_between(
            ds.camera_poses[idx1], ds.camera_poses[idx2], n_renders=16
        )
        rendered = []
        for i, c2w in enumerate(path):
            result, _ = self._render_frame(params, self._key(100 + i), c2w)
            rendered.append(result.rgb.cpu().numpy())
        if not self.writes:
            return
        plots.save_interpolation_plot(
            self.save_dir, ds.images[idx1], ds.images[idx2], rendered
        )

    # ------------------------------------------------------------------ #
    # Cloud backup (reference src/ExecutionRun.py:154-167)                #
    # ------------------------------------------------------------------ #

    def backup_to_gcp(self) -> None:
        bucket = self.run.google_cloud_bucket_name
        if not bucket:
            return
        dest = f"{bucket.rstrip('/')}/{self.save_dir}"
        if "_datetime_" not in str(self.save_dir):
            dest += f"_datetime_{self.datetime_start}"
        cmd = ["gsutil", "-m", "rsync", "-r", str(self.save_dir), dest]
        print("Calling:", " ".join(cmd))
        subprocess.run(cmd, check=False)
