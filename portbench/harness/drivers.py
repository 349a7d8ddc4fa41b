"""The traffic kinds: how a cell drives the program, and what its check
compares.

Each kind builds the program's objects through the entries a user's run
goes through (the ``Trainer``, ``train_step.make_epoch_fn``,
``render_tiles.render_frame``), hands it the benchmark's scene and weights,
and exposes one call of the window. The program is imported inside the
methods, so the harness imports without it.

What the check compares is what the timed path produced: the training cells'
first steps go through the window's own epoch function and feed (one step a
call, on the device table and the program's own permutation) and hand their
state on to the window; the render cell's frames are those of the window.
The reference then works each of them out again from the benchmark's inputs
and the replayed random draws. In training it takes the fine samples that
the judged side resampled, and works out their gradient itself: the
resampling is held apart, by the first step's samples (``z_gap``).
"""

from __future__ import annotations

import dataclasses
import tempfile
from typing import Dict, List, Optional
from unittest import mock

import numpy as np
import torch

from harness import scene, weights
from harness.window import Window, nearest_rank, rate
from reference import nerf as ref_nerf, train as ref_train
from reference.precision import CONTROL_OF, rounder

# The layers of a radiance network that map its features to colour.
RGB_HEADS = ("rgb_hidden", "rgb_out")

# Tags of the seeds drawn from a run's --seed (tag 2 is not used).
SCENE, WEIGHTS, CHECK, CALL, FRAME, POSES, SAMPLE, WARM = 0, 1, 3, 4, 5, 6, 7, 8


def sub_seed(seed: int, tag: int, index: int = 0) -> int:
    """A 63-bit seed for one use of the run's seed."""
    seq = np.random.SeedSequence([seed % 2 ** 64 & 0xFFFFFFFF, seed % 2 ** 64 >> 32, tag, index])
    hi, lo = seq.generate_state(2, dtype=np.uint32)
    return (int(hi) << 32 | int(lo)) & (2 ** 63 - 1)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def replayed_draws(gen, rows: int, n_coarse: int, n_fine: int, device):
    """What the program draws from ``gen`` for ``rows`` rays, in its order:
    the stratified uniforms, then the resampling's sorted uniforms (from
    ``n_fine + 1`` exponentials a row)."""
    strat = torch.rand((rows, n_coarse), generator=gen, device=device)
    e = torch.empty((rows, n_fine + 1), device=device)
    e.exponential_(generator=gen)
    return {"strat_u": strat, "fine_u": ref_nerf.sorted_uniforms(e)}


def run_config(cfg: dict):
    """The program's ``RunConfig`` of a configuration file: its keys that are
    the run config's fields."""
    from nerf_and_dietnerf_tpu_torch.utils.config import RunConfig

    fields = {f.name for f in dataclasses.fields(RunConfig)}
    return RunConfig(**{k: v for k, v in cfg.items() if k in fields})


def _tree_copy(tree):
    if isinstance(tree, dict):
        return {k: _tree_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_copy(v) for v in tree]
    return tree.clone()


def _norms(ts) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(t.double())) for t in ts])


def _leaf_gaps(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> np.ndarray:
    """Each leaf's gap between the two sides' norms, over the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    p, r = _norms(prog), _norms(ref)
    return np.abs(p - r) / np.maximum(r, float(np.median(r)))


def held_leaves(names: List[str]) -> np.ndarray:
    """The leaves whose gradient does not pass through the resampling's
    derivative: every leaf of the fine network and the coarse network's
    colour heads."""
    return np.array([n.startswith("fine.") or n.split(".")[1] in RGB_HEADS for n in names])


def z_gaps(judged: Dict, ref: Dict, span: float) -> np.ndarray:
    """The first step's resampled samples: each one's gap between the judged
    side and the reference's own resampling, over the depth range ``span``;
    not finite where the judged side resampled no such samples."""
    zj, zr = judged["z"][0], ref["z"][0]
    if zj is None or zj.shape != zr.shape:
        return np.array([np.inf])
    return ((zj.double() - zr.double()).abs() / span).reshape(-1).cpu().numpy()


def train_numbers(judged: Dict, ref: Dict) -> Dict[str, float]:
    """``loss_gap``: the first step's loss, relative; ``grad_gap``: the first
    step's gradient, the median leaf's gap; ``grad_gap_held``: the same by
    the worst of the held leaves (:func:`held_leaves`); ``change_gap``: the
    parameters' change over the checked steps, the median leaf's gap,
    leaving out leaves whose reference gradient is under a thousandth of the
    median leaf's (nought but for rounding: they move under Adam by
    round-off alone); ``z_gap``: the 99th percentile of the first step's
    resampled samples' gaps. Why these: ``PERF.md``, "How correct is
    decided"."""
    d = train_diagnostics(judged, ref)
    return {k: d[k] for k in ("loss_gap", "grad_gap", "grad_gap_held", "change_gap", "z_gap")}


def train_diagnostics(judged: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers and, beside them, what they were chosen over:
    every step's loss gap, the worst and the upper-quartile leaf, the held
    leaves' median, the fine trunk's worst, the coarse network's worst, the
    resampled samples' quantiles, and every leaf's gap."""
    losses = [abs(a - b) / abs(b) for a, b in zip(judged["losses"], ref["losses"])]
    g = _norms(ref["grad1"])
    keep = g >= 1e-3 * np.median(g)
    grad = _leaf_gaps(judged["grad1"], ref["grad1"])
    change = _leaf_gaps([t for t, k in zip(judged["change"], keep) if k],
                        [t for t, k in zip(ref["change"], keep) if k])
    names = ref["names"]
    held = held_leaves(names)
    fine_trunk = np.array([n.startswith("fine.trunk.") for n in names])
    z = z_gaps(judged, ref, ref["span"])
    if not np.isfinite(z).all():
        z = np.array([np.inf])  # a quantile of it would read nan
    out = {"loss_gap": losses[0], "grad_gap": float(np.median(grad)),
           "grad_gap_held": float(grad[held].max()), "change_gap": float(np.median(change)),
           "z_gap": float(np.quantile(z, 0.99, method="lower"))}
    out.update({f"loss_gap.{i + 1}": v for i, v in enumerate(losses)})
    out.update({"grad_gap.worst": float(grad.max()), "grad_gap.q3": float(np.quantile(grad, 0.75)),
                "grad_gap.held.median": float(np.median(grad[held])),
                "grad_gap.fine_trunk.worst": float(grad[fine_trunk].max()),
                "grad_gap.coarse.worst": float(grad[~held].max()),
                "change_gap.worst": float(change.max()),
                "change_gap.q3": float(np.quantile(change, 0.75)),
                "leaves_left_out": int((~keep).sum()),
                "z_gap.median": float(np.median(z)),
                "z_gap.p999": float(np.quantile(z, 0.999, method="lower")),
                "z_gap.max": float(z.max()), "z_gap.over_1e-3": float((z > 1e-3).mean())})
    out["grad_leaves"] = [float(x) for x in grad]
    return out


def frame_diagnostics(prog: Dict[int, np.ndarray], ref: Dict[int, np.ndarray]) -> Dict[str, float]:
    gap = np.concatenate([np.abs(prog[k] - ref[k]).reshape(-1) for k in ref])
    return {"frame_gap": float(np.quantile(gap, 0.99)), "frame_gap.max": float(gap.max()),
            "frame_gap.mean": float(gap.mean()), "frame_gap.p999": float(np.quantile(gap, 0.999)),
            "frame_gap.over_1e-3": float((gap > 1e-3).mean())}


class Train:
    """``train``: back-to-back NeRF training steps through the ``Trainer``'s
    epoch function, in calls of ``steps_per_call`` steps on the device ray
    table, each call ending in a host read of its mean loss."""

    rate_metric = "train_rays_per_s"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.dims = weights.mlp_dims(cfg)
        self.batch = cfg["n_rays_in_batch_train"]
        self.precision = cfg["compute_dtype"]
        self.record: Dict = {}

    # -- the program ---------------------------------------------------------
    def _epoch_fn(self, n_batches: int):
        from nerf_and_dietnerf_tpu_torch.train import train_step as ts

        tr = self.trainer
        return ts.make_epoch_fn(tr.config, tr.optimizer, n_batches, self.batch)

    def _checked_step(self, state, i: int):
        """Check step ``i`` through the window's epoch function, and the fine
        samples it resampled (None unless it resampled once)."""
        from nerf_and_dietnerf_tpu_torch.core import sampling

        resampled = []
        whole = sampling.resample_z_from_weights

        def recorded(*args, **kwargs):
            z = whole(*args, **kwargs)
            resampled.append(z.detach().clone())
            return z

        with mock.patch.object(sampling, "resample_z_from_weights", recorded):
            state, metrics = self.step_fn(state, _generator(self.device,
                                                            sub_seed(self.seed, CHECK, i)),
                                          *self.tables)
        return state, metrics, resampled[0] if len(resampled) == 1 else None

    def set_up(self) -> None:
        from nerf_and_dietnerf_tpu_torch.data.loaders import Dataset
        from nerf_and_dietnerf_tpu_torch.train import train_step as ts
        from nerf_and_dietnerf_tpu_torch.train.trainer import Trainer
        from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

        self.images, self.poses = scene.sphere_scene(self.cfg["scene"], sub_seed(self.seed, SCENE))
        dataset = Dataset(images=self.images, camera_poses=self.poses,
                          field_of_view=self.cfg["scene"]["fov"],
                          near=self.cfg["near_depth_render"], far=self.cfg["far_depth_render"],
                          average_c2w_before_recenter=np.eye(4), scale=1.0)
        self._save_dir = tempfile.TemporaryDirectory(prefix="portbench-")
        self.trainer = Trainer(run_config(self.cfg), dataset, self._save_dir.name,
                               device=self.device)
        tr = self.trainer
        self.train_views = list(tr.train_indices)
        self.params0 = weights.nerf_params(self.dims, sub_seed(self.seed, WEIGHTS), self.device)
        params = _tree_copy(self.params0)
        state = ts.TrainState(params=params, opt_state=tr.optimizer.init(params), step=0)
        self.tables = tuple(torch.as_tensor(a, device=self.device)
                            for a in (tr.data.origins, tr.data.directions, tr.data.rgb))
        if self.traffic["steps_per_call"] > tr.data.batches_per_epoch:
            raise ValueError("a call of the traffic holds more steps than an epoch has batches")
        self.step_fn = self._epoch_fn(1)
        self.call_fn = self._epoch_fn(self.traffic["steps_per_call"])
        losses, zs = [], []
        for i in range(self.traffic["check_steps"]):
            state, metrics, z = self._checked_step(state, i)
            losses.append(float(metrics["loss"]))
            zs.append(z)
            if i == 0:
                # Adam's first moment after one step is (1 - b1) g.
                grad1 = [m / (1.0 - ref_train.B1) for m in tree_leaves(state.opt_state["mu"])]
        change = [p - p0 for p, p0 in zip(tree_leaves(state.params), ref_train.leaves(self.params0))]
        self.record = {"losses": losses, "grad1": grad1, "change": change, "z": zs}
        # One call of the window's own epoch function, so that nothing it
        # runs is first loaded inside the window.
        gen = _generator(self.device, sub_seed(self.seed, WARM))
        self.state, metrics = self.call_fn(state, gen, *self.tables)
        float(metrics["loss"])

    def call(self, k: int):
        gen = _generator(self.device, sub_seed(self.seed, CALL, k))
        self.state, metrics = self.call_fn(self.state, gen, *self.tables)
        return self.traffic["steps_per_call"], float(metrics["loss"])  # the host read ends the call

    def release(self) -> None:
        for name in ("trainer", "state", "tables", "step_fn", "call_fn"):
            self.__dict__.pop(name, None)
        self._save_dir.cleanup()

    # -- the window's numbers ------------------------------------------------
    def end_to_end(self, win: Window) -> Dict[str, float]:
        return {self.rate_metric: rate(win.units * self.batch, win.seconds)}

    def work(self, win: Window) -> Dict:
        n_s = self.cfg["n_render_samples_coarse"] + self.cfg["n_render_samples_fine"]
        return {"steps": win.units, "rows_fwd": win.units * self.batch * n_s,
                "rows_bwd": win.units * self.batch * n_s, "launches": 2 * win.units}

    # -- the check -----------------------------------------------------------
    def _batch(self, i: int) -> Dict:
        """Check step ``i``'s rays, colours and draws, replayed: the
        permutation the epoch function draws first, the step's draws next."""
        gen = _generator(self.device, sub_seed(self.seed, CHECK, i))
        h, w = self.images.shape[1:3]
        rows = torch.randperm(len(self.train_views) * h * w, generator=gen,
                              device=self.device)[:self.batch]
        draws = replayed_draws(gen, self.batch, self.cfg["n_render_samples_coarse"],
                               self.cfg["n_render_samples_fine"], self.device)
        view = rows // (h * w)
        pix = rows % (h * w)
        o = torch.empty((self.batch, 3), device=self.device)
        d = torch.empty_like(o)
        for v in torch.unique(view).tolist():
            at = view == v
            c2w = torch.as_tensor(self.poses[self.train_views[v]], device=self.device)
            o[at], d[at] = ref_nerf.pixel_rays(c2w, h, w, self.cfg["scene"]["fov"],
                                               pix[at] // w, pix[at] % w)
        rgb = self.images_t[torch.as_tensor(self.train_views, device=self.device)[view],
                            pix // w, pix % w]
        return dict(draws, o=o, d=d, rgb=rgb)

    def reference(self, precision: Optional[str] = None, fault: Optional[str] = None,
                  follow: Optional[List] = None) -> Dict:
        """The checked steps worked out by the reference, in ``precision``
        (the configuration's by default), with ``fault`` planted; with
        ``follow``, each step's fine pass on those resampled samples where
        they are one a ray and sample."""
        self.images_t = torch.as_tensor(self.images, device=self.device)
        batches = [self._batch(i) for i in range(self.traffic["check_steps"])]
        for b, z in zip(batches, follow or []):
            if z is not None and z.shape == b["fine_u"].shape:
                b["z_follow"] = z
        out = ref_train.run_steps(self.params0, self.dims, batches,
                                  rounder(precision or self.precision), self.cfg["optimizer_lr"],
                                  fault=fault)
        del self.images_t
        out["span"] = self.cfg["far_depth_render"] - self.cfg["near_depth_render"]
        return out

    numbers = staticmethod(train_numbers)
    diagnostics = staticmethod(train_diagnostics)

    def pair(self, side: str = "program"):
        """``(judged, reference)`` outputs of the checked steps. ``side``:
        "program" (what the timed path produced), "control" (the reference
        one precision below the configuration's in the program's place),
        "self" (the reference again), "fault:<name>" (the reference with
        the fault planted). The reference follows the judged side's
        resampled samples."""
        if side == "program":
            judged = self.record
        elif side == "control":
            judged = self.reference(CONTROL_OF[self.precision])
        elif side == "self":
            judged = self.reference()
        else:
            judged = self.reference(fault=_fault(self, side))
        return judged, self.reference(follow=judged["z"])

    def check(self) -> Dict[str, float]:
        return self.numbers(*self.pair())

    faults = ("unchanged_state", "half_batch", "trunk_grad_doubled")


def _fault(driver, side: str) -> str:
    """The fault named by ``side`` ("fault:<name>"), one the driver plants."""
    kind, _, name = side.partition(":")
    if kind != "fault" or name not in driver.faults:
        raise ValueError(f"unknown side {side!r}; faults: {driver.faults}")
    return name


class Render:
    """``render``: full frames through ``render_tiles.render_frame`` as the
    eval render and the video task call it (the ``Trainer``'s f32
    ``eval_config``, its offline chunk size, a generator a frame), from poses
    along a seeded orbit, one frame at a time, each frame's rgb copied to the
    host."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.dims = weights.mlp_dims(cfg)
        self.frames: List[np.ndarray] = []

    def set_up(self) -> None:
        from nerf_and_dietnerf_tpu_torch.data.loaders import Dataset
        from nerf_and_dietnerf_tpu_torch.train.trainer import Trainer

        images, poses = scene.sphere_scene(self.cfg["scene"], sub_seed(self.seed, SCENE))
        dataset = Dataset(images=images, camera_poses=poses, field_of_view=self.cfg["scene"]["fov"],
                          near=self.cfg["near_depth_render"], far=self.cfg["far_depth_render"],
                          average_c2w_before_recenter=np.eye(4), scale=1.0)
        self._save_dir = tempfile.TemporaryDirectory(prefix="portbench-")
        self.trainer = Trainer(run_config(self.cfg), dataset, self._save_dir.name,
                               device=self.device)
        self.size = (dataset.height, dataset.width)
        self.chunk = min(self.trainer.run.offline_chunk_size(), self.size[0] * self.size[1])
        self.params0 = weights.nerf_params(self.dims, sub_seed(self.seed, WEIGHTS), self.device)
        self.params = _tree_copy(self.params0)
        self.poses = scene.orbit_poses(self.traffic["orbit"], self.traffic["max_frames"],
                                       sub_seed(self.seed, POSES))
        warm = scene.orbit_poses(self.traffic["orbit"], 1, sub_seed(self.seed, WARM))[0]
        self._frame(warm, sub_seed(self.seed, WARM))

    def _frame(self, c2w, seed: int) -> np.ndarray:
        from nerf_and_dietnerf_tpu_torch.parallel import render_tiles

        tr = self.trainer
        result, _ = render_tiles.render_frame(
            self.params, tr.eval_config, tr.mesh, _generator(self.device, seed), c2w,
            self.cfg["scene"]["fov"], self.size[0], self.size[1],
            chunk_size=tr.run.offline_chunk_size(), diagnostics=False, device=self.device)
        return result.rgb.cpu().numpy()

    def call(self, k: int):
        rgb = self._frame(self.poses[k], sub_seed(self.seed, FRAME, k))
        self.frames.append(rgb)
        return 1, float(rgb.sum())

    def release(self) -> None:
        for name in ("trainer", "params"):
            self.__dict__.pop(name, None)
        self._save_dir.cleanup()

    def end_to_end(self, win: Window) -> Dict[str, float]:
        return {"render_frame_ms": 1e3 * win.seconds / win.units,
                "render_frame_p90_ms": 1e3 * nearest_rank(win.calls, 0.9)}

    def work(self, win: Window) -> Dict:
        h, w = self.size
        n_c, n_f = self.cfg["n_render_samples_coarse"], self.cfg["n_render_samples_fine"]
        rays = win.units * h * w
        return {"frames": win.units, "rows_fwd": rays * (n_c + n_c + n_f),
                "launches": 2 * win.units * (-(-h * w // self.chunk))}

    # -- the check -----------------------------------------------------------
    def sample(self) -> List[int]:
        """The frames the check compares, drawn from the seed."""
        n = min(self.traffic["check_frames"], len(self.frames))
        rng = np.random.default_rng(sub_seed(self.seed, SAMPLE))
        return sorted(int(k) for k in rng.choice(len(self.frames), n, replace=False))

    def reference(self, frames: List[int], precision: Optional[str] = None,
                  fault: Optional[str] = None) -> Dict[int, np.ndarray]:
        out = {}
        h, w = self.size
        n_c, n_f = self.cfg["n_render_samples_coarse"], self.cfg["n_render_samples_fine"]
        for k in frames:
            gen = _generator(self.device, sub_seed(self.seed, FRAME, k))
            chunks = [replayed_draws(gen, self.chunk, n_c, n_f, self.device)
                      for _ in range(-(-h * w // self.chunk))]
            frame = ref_nerf.render_frame(
                self.params0, self.dims, torch.as_tensor(self.poses[k], device=self.device), h, w,
                self.cfg["scene"]["fov"], chunks, rounder(precision or "float32")).cpu().numpy()
            if fault == "altered_answer":
                frame += 1.0 / 255.0
            elif fault == "half_batch":
                frame.reshape(-1, 3)[h * w // 2:] = 0.0
            out[k] = frame
        return out

    @staticmethod
    def numbers(prog: Dict[int, np.ndarray], ref: Dict[int, np.ndarray]) -> Dict[str, float]:
        """``frame_gap``: the 99th percentile of the gaps of the compared
        frames' pixel channels (why not the largest: ``PERF.md``)."""
        return {"frame_gap": frame_diagnostics(prog, ref)["frame_gap"]}

    diagnostics = staticmethod(frame_diagnostics)

    def pair(self, side: str = "program"):
        """As :meth:`Train.pair`; the program's side judges the frames of
        the window drawn from the seed, the others the first frames."""
        if side == "program":
            frames = self.sample()
            return {k: self.frames[k] for k in frames}, self.reference(frames)
        frames = list(range(self.traffic["check_frames"]))
        ref = self.reference(frames)
        if side == "control":
            return self.reference(frames, "tfloat32"), ref
        if side == "self":
            return self.reference(frames), ref
        return self.reference(frames, fault=_fault(self, side)), ref

    def check(self) -> Dict[str, float]:
        return self.numbers(*self.pair())

    faults = ("altered_answer", "half_batch")


KINDS = {"train": Train, "render": Render}
