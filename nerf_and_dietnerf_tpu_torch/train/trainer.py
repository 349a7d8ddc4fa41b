"""Epoch-loop trainer (NeRF; DietNeRF in ``diet_trainer``).

Port of ``nerf_and_dietnerf_tpu/train/trainer.py``: an epoch loop over the
ray table kept on the device, per-epoch full-frame f32 eval renders with
PSNR tracking, reference-format ``.h5`` + PSNR-npy artifacts and full
train-state checkpoints. Randomness follows the JAX package's keys as
generator seeds: init from ``init_seed``, epoch ``e``'s permutation and
steps from seed ``e``, its eval renders from seed ``10000 + e``. Over a
data-parallel group each rank trains on its rows of every batch and renders
its tiles of every eval frame; rank 0 alone writes the files.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, List, Optional

import torch

from nerf_and_dietnerf_tpu_torch.core import rendering
from nerf_and_dietnerf_tpu_torch.data import loaders, pipeline
from nerf_and_dietnerf_tpu_torch.data.loaders import Dataset
from nerf_and_dietnerf_tpu_torch.models.nerf import NeRFConfig
from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib, render_tiles
from nerf_and_dietnerf_tpu_torch.train import checkpoint, train_step as ts
from nerf_and_dietnerf_tpu_torch.utils.config import RunConfig
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class EpochStats:
    epoch: int
    loss: float
    psnr_train: float
    psnr_test: float
    rays_per_sec: float
    seconds: float


class Trainer:
    """Drives training for one run config over one dataset.

    :param run: parsed YAML run config.
    :param dataset: loaded scene.
    :param save_dir: run artifact directory (weights, PSNR history, states).
    :param device: where to train; the GPU unless ``device="cpu"`` is given.
    :param epoch_callback: called with ``(trainer, EpochStats)`` after each
        epoch's artifacts are saved (the runner hooks its epoch plot and cloud
        backup here, as in ``src/ExecutionRun.py:193-201``).
    :param mesh: the ``parallel.mesh.DataGroup`` of a multi-GPU run (its
        device is this rank's); None trains on one device, whatever
        ``mesh_data_devices`` says (the runner builds the group), as in the
        JAX package.
    """

    trains_dietnerf = False  # DietTrainer adds the consistency loss

    def __init__(self, run: RunConfig, dataset: Dataset, save_dir, device=None,
                 epoch_callback: Optional[Callable] = None, mesh=None):
        # The JAX runner sends DietNeRF configs to the DietTrainer; training
        # them here as plain NeRF would give another result without saying so.
        if run.is_dietnerf and not self.trains_dietnerf:
            raise NotImplementedError(
                "type_of_model DietNeRF: this Trainer trains NeRF only; train DietNeRF "
                "configs with train.diet_trainer.DietTrainer (the runner picks it)")
        self.run = run
        self.dataset = dataset
        self.save_dir = Path(save_dir)
        self.device = resolve_device(device)
        self.epoch_callback = epoch_callback
        self.mesh = mesh

        # near/far come from the loader (spherification rescales them).
        self.config: NeRFConfig = dataclasses.replace(
            run.nerf_config(), near=dataset.near, far=dataset.far, mesh=mesh
        )
        # Eval renders always run in f32, through the same backend, with the
        # train-path fusions off (as in the JAX package); on a group they are
        # tile-sharded by render_tiles.render_frame.
        self.eval_config = dataclasses.replace(
            self.config, compute_dtype=torch.float32, fuse_compositing=False,
            fuse_fine_loss=False, mesh=None)
        self.train_indices = loaders.train_test_split_indices(
            len(dataset), run.test_img_idx, run.pics_indices_to_use_in_dataset
        )
        self.data = pipeline.RayDataset(
            dataset.images[self.train_indices], dataset.camera_poses[self.train_indices],
            dataset.field_of_view, run.n_rays_in_batch_train,
            process_index=0 if mesh is None else mesh.rank,
            process_count=1 if mesh is None else mesh.world_size,
        )
        self.optimizer = ts.make_optimizer_with_schedule(
            run.optimizer_lr, lr_final=run.optimizer_lr_final,
            total_steps=run.n_epochs * self.data.batches_per_epoch,
            grad_clip_norm=run.grad_clip_norm,
        )
        self.state = ts.init_train_state(
            torch.Generator().manual_seed(run.init_seed), self.config, self.optimizer,
            device=self.device,
        )
        self.start_epoch = 0
        self.ckpt = checkpoint.CheckpointManager(self.save_dir / "states")
        self._maybe_resume()
        self._epoch_fn = None  # built at the first epoch (_make_epoch_fn)
        self._tables = None
        self._eval_render_cache = None
        self.psnrs_test: List[float] = []
        self.psnrs_train: List[float] = []
        if self.start_epoch > 0:
            self.psnrs_test, self.psnrs_train = checkpoint.load_psnr_history(
                self.save_dir, self.start_epoch)

    def _maybe_resume(self) -> None:
        """A non-negative ``starting_epoch_number`` loads that epoch's ``.h5``
        (weights only: Adam's moments restart from zero, as in the reference).
        The optimizer count fast-forwards to the epoch's step, so an lr
        schedule resumes where it was; like the JAX package, this also skips
        most of Adam's bias correction for the fresh moments (``ADVICE.md``
        item 1). A saved full state for the same step is preferred."""
        epoch = self.run.starting_epoch_number
        if epoch is None or epoch < 0:
            return
        h5 = checkpoint.nerf_h5_path(self.save_dir, epoch)
        if h5.exists():
            params = checkpoint.load_keras_h5(h5, self.config.mlp, has_fine=self.config.has_fine,
                                              device=self.device)
            step = epoch * self.data.batches_per_epoch
            opt_state = self.optimizer.init(params)
            opt_state["count"] = step
            self.state = ts.TrainState(params=params, opt_state=opt_state, step=step)
        self.start_epoch = epoch
        if self.ckpt.latest_step() == epoch:
            restored = self.ckpt.restore(epoch, map_location=self.device)
            if restored is not None:
                self.state = restored

    def _make_epoch_fn(self):
        """``epoch_fn(state, key, origins, dirs, rgb) -> (state, mean_metrics)``
        over the device's ray table."""
        return ts.make_epoch_fn(self.config, self.optimizer, self.data.batches_per_epoch,
                                self.run.n_rays_in_batch_train, mesh=self.mesh)

    def train_epoch(self, epoch: int) -> EpochStats:
        """One pass over the permuted ray table, then the eval PSNRs."""
        self._eval_render_cache = None
        n_batches = self.data.batches_per_epoch
        if n_batches == 0:
            raise ValueError("batch size exceeds the number of training rays; nothing to train")
        if self._epoch_fn is None:
            self._epoch_fn = self._make_epoch_fn()
        if self._tables is None:
            self._tables = tuple(
                torch.as_tensor(a, device=self.device)
                for a in (self.data.origins, self.data.directions, self.data.rgb))
        gen = torch.Generator(device=self.device).manual_seed(epoch)
        t0 = time.perf_counter()
        self.state, metrics = self._epoch_fn(self.state, gen, *self._tables)
        loss_value = float(metrics["loss"])  # host read: the timing fence
        dt = time.perf_counter() - t0

        psnr_train, psnr_test = self._eval_psnrs(epoch)
        self.psnrs_train.append(psnr_train)
        self.psnrs_test.append(psnr_test)
        return EpochStats(epoch=epoch, loss=loss_value, psnr_train=psnr_train,
                          psnr_test=psnr_test,
                          rays_per_sec=n_batches * self.run.n_rays_in_batch_train / dt,
                          seconds=dt)

    def _eval_psnrs(self, epoch: int):
        renders = self.render_eval_images(epoch)
        out = []
        for name in ("train", "test"):
            idx, rgb = renders[name]
            out.append(float(rendering.psnr(torch.as_tensor(self.dataset.images[idx]),
                                            torch.as_tensor(rgb))))
        return out[0], out[1]

    def render_eval_images(self, epoch: int):
        """The train-image and test-image renders of the epoch's PSNRs,
        memoized per epoch: ``{"train": (idx, rgb), "test": (idx, rgb)}``."""
        if self._eval_render_cache is not None and self._eval_render_cache[0] == epoch:
            return self._eval_render_cache[1]
        ds = self.dataset
        gen = torch.Generator(device=self.device).manual_seed(10_000 + epoch)
        renders = {}
        for name, idx in (("train", self.run.idx_train_img_to_plot),
                          ("test", self.run.test_img_idx)):
            result, _ = render_tiles.render_frame(
                self.state.params, self.eval_config, self.mesh, gen, ds.camera_poses[idx],
                ds.field_of_view, ds.height, ds.width,
                chunk_size=self.run.offline_chunk_size(), diagnostics=False,
                device=self.device,
            )
            renders[name] = (idx, result.rgb.cpu().numpy())
        self._eval_render_cache = (epoch, renders)
        return renders

    def save_epoch_artifacts(self, epoch: int) -> None:
        """Reference-format ``.h5`` weights + PSNR history + the full state,
        written by rank 0 alone on a group (the ranks hold the same state);
        the others wait at a barrier until the files are written."""
        if self.mesh is None or self.mesh.rank == 0:
            checkpoint.save_keras_h5(checkpoint.nerf_h5_path(self.save_dir, epoch),
                                     self.state.params, self.config.mlp)
            checkpoint.save_psnr_history(self.save_dir, epoch, self.psnrs_test,
                                         self.psnrs_train)
            self.ckpt.save(epoch, self.state)
        if self.mesh is not None:
            mesh_lib.barrier(self.mesh)

    def fit(self, n_epochs: Optional[int] = None, log=print) -> List[EpochStats]:
        n_epochs = n_epochs if n_epochs is not None else self.run.n_epochs
        history = []
        for epoch in range(self.start_epoch + 1, n_epochs + 1):
            stats = self.train_epoch(epoch)
            self.save_epoch_artifacts(epoch)
            if log is not None:
                log(f"epoch {epoch}/{n_epochs}: loss={stats.loss:.5f} "
                    f"psnr_train={stats.psnr_train:.2f} psnr_test={stats.psnr_test:.2f} "
                    f"{stats.rays_per_sec:,.0f} rays/s ({stats.seconds:.1f}s)")
            if self.epoch_callback is not None:
                self.epoch_callback(self, stats)
            history.append(stats)
        return history

