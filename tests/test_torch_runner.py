"""Port vs JAX package: the runner, the viz modules, the save directory and the
CLI, on the CPU at the tiny size of tests/test_runner.py."""

import copy
import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from nerf_and_dietnerf_tpu.data.loaders import Dataset as JDataset
from nerf_and_dietnerf_tpu.tasks import runner as jrunner
from nerf_and_dietnerf_tpu.utils import config as jconfig
from nerf_and_dietnerf_tpu.viz import image_ops as jimage_ops
from nerf_and_dietnerf_tpu.viz import plots as jplots
from nerf_and_dietnerf_tpu.viz import video as jvideo
from nerf_and_dietnerf_tpu_torch import main as tmain
from nerf_and_dietnerf_tpu_torch.data.loaders import Dataset as TDataset
from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib
from nerf_and_dietnerf_tpu_torch.tasks import runner as trunner
from nerf_and_dietnerf_tpu_torch.train import checkpoint as tckpt
from nerf_and_dietnerf_tpu_torch.train.trainer import Trainer
from nerf_and_dietnerf_tpu_torch.utils import config as tconfig
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves
from nerf_and_dietnerf_tpu_torch.viz import image_ops as timage_ops
from nerf_and_dietnerf_tpu_torch.viz import plots as tplots
from nerf_and_dietnerf_tpu_torch.viz import video as tvideo

# tests/test_runner.py's CONFIG: hidden 16, 4 + 4 samples, 10x10 images.
CONFIG = {
    "dataset_type": "colmap",
    "dataset_location": "unused",
    "general_save_location": None,  # filled per test
    "tasks_to_perform": {
        "start_training": True,
        "render_and_save_test_left_to_right_video": True,
        "render_and_save_test_sphere_video": True,
        "render_and_save_test_path_video": True,
        "save_dataset_video": True,
        "save_plots_video": True,
        "create_plots_that_visualize_values_along_rays": True,
        "create_plot_that_visualize_rendering_between_2_images": True,
    },
    "neural_net": {
        "type_of_model": "NeRF",
        "hidden_layer_dim": 16,
        "last_hidden_layer_dim": 8,
        "n_pos_enc_dim_xyz": 2,
        "n_pos_enc_view_dir": 2,
        "n_angles_for_model": 2,
        "n_rays_in_batch_train": 60,
        "n_rays_in_batch_render": 100,
    },
    "render": {
        "n_render_samples_coarse": 4,
        "n_render_samples_fine": 4,
        "near_depth_render": 0.5,
        "far_depth_render": 3.0,
    },
    "training": {
        "n_epochs": 1,
        "optimizer_lr": 5.0e-4,
        "test_img_idx": 0,
        "idx_train_img_to_plot": 1,
    },
    "video": {
        "fps_plot_video": 2,
        "fps_render_video": 1,
        "fps_train_set_video": 2,
        "img_indices_for_path_video": [1, 2, 3],
    },
    "mesh": {"compute_dtype": "float32"},
}
ALL_TASKS = CONFIG["tasks_to_perform"]
RENDER_TASKS = {k: v for k, v in ALL_TASKS.items() if k != "start_training"}
# The full-state checkpoints: Orbax in the JAX package, torch.save in the port.
STATE_DIRS = {"orbax", "states"}
ATOL = 1e-5  # tests/test_torch_nerf.py's render tolerance


def scene(n=4, h=10, w=10):
    """tests/test_runner.py's synthetic scene as the two packages' datasets."""
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * n)
    poses[:, 2, 3] = 2.0 + 0.2 * np.arange(n)
    poses[:, 0, 3] = 0.1 * np.arange(n)
    fields = dict(images=images, camera_poses=poses, field_of_view=0.8, near=0.5, far=3.0,
                  average_c2w_before_recenter=np.eye(4), scale=1.0)
    return JDataset(**fields), TDataset(**fields)


def ring_scene(n=6, size=8):
    """Cameras on a ring looking at a point: a spherical scene."""
    poses = []
    for i in range(n):
        phi = 2 * np.pi * i / n
        pos = np.array([3 * np.sin(phi), 0.5, 3 * np.cos(phi)]) + [0.2, 0.1, -0.3]
        z = (pos - [0.2, 0.1, -0.3]) / np.linalg.norm(pos - [0.2, 0.1, -0.3])
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, pos
        poses.append(c2w)
    fields = dict(images=np.zeros((n, size, size, 3), np.float32),
                  camera_poses=np.asarray(poses, np.float32), field_of_view=0.8, near=0.5,
                  far=3.0, average_c2w_before_recenter=np.eye(4), scale=1.0)
    return JDataset(**fields), TDataset(**fields)


@pytest.fixture
def datasets(monkeypatch):
    jds, tds = scene()
    monkeypatch.setattr(jrunner.loaders, "load_dataset", lambda *a, **k: jds)
    monkeypatch.setattr(trunner.loaders, "load_dataset", lambda *a, **k: tds)
    return jds, tds


def write_config(path: Path, save_root: Path, **changes) -> Path:
    cfg = copy.deepcopy(CONFIG)
    cfg["general_save_location"] = str(save_root)
    for key, value in changes.items():
        if isinstance(value, dict) and key in cfg and key != "tasks_to_perform":
            cfg[key].update(value)
        else:
            cfg[key] = value
    path.write_text(yaml.safe_dump(cfg))
    return path


def artifact_names(save_dir: Path):
    return sorted(
        str(p.relative_to(save_dir)) for p in save_dir.rglob("*")
        if p.is_file() and p.relative_to(save_dir).parts[0] not in STATE_DIRS)


def test_all_tasks_write_the_jax_runners_files(tmp_path, datasets):
    cfg = write_config(tmp_path / "tiny_run.yaml", tmp_path / "unused")
    ref = jrunner.Runner(cfg, save_root=str(tmp_path / "jax"))
    ref.start()
    got = trunner.Runner(cfg, save_root=str(tmp_path / "port"), device="cpu")
    got.start()

    assert got.save_dir.name == ref.save_dir.name == "tiny_run_save_dir_0"
    assert artifact_names(got.save_dir) == artifact_names(ref.save_dir)
    assert (got.save_dir / "states").is_dir() and (ref.save_dir / "orbax").is_dir()
    vid = got.save_dir / trunner.VIDEOS_DIRNAME
    assert len(list(vid.glob("*.avi"))) == 8
    assert all(p.stat().st_size > 0 for p in vid.glob("*.avi"))
    assert len(list((got.save_dir / tplots.SPECIAL_PLOTS_DIRNAME).glob("ray_values_*.jpg"))) == 3


def _record(monkeypatch, module, name, out: list, call_real=False):
    real = getattr(module, name)

    def recorder(*args, **kwargs):
        out.append(args)
        return real(*args, **kwargs) if call_real else None

    monkeypatch.setattr(module, name, recorder)


def _render_all(monkeypatch, runner_mod, runner, image_ops, plots, video):
    """Every render task of ``runner`` with the render key None and the
    writers intercepted; returns what reached them."""
    rec = {k: [] for k in ("frames", "plot_video", "depth", "rays", "interp")}
    _record(monkeypatch, video, "save_frames_as_video", rec["frames"])
    _record(monkeypatch, video, "save_plot_video", rec["plot_video"])
    _record(monkeypatch, image_ops, "histogram_equalize", rec["depth"], call_real=True)
    _record(monkeypatch, plots, "save_ray_value_plots", rec["rays"])
    _record(monkeypatch, plots, "save_interpolation_plot", rec["interp"])
    real = runner_mod.Runner._render_frame
    monkeypatch.setattr(runner_mod.Runner, "_render_frame",
                        lambda self, params, key, c2w, diagnostics=False:
                        real(self, params, None, c2w, diagnostics))
    runner.start()
    return rec


def test_renders_from_one_h5_match_jax(tmp_path, datasets, monkeypatch):
    """The JAX runner trains one epoch; each package resumes from its .h5 and
    renders every task deterministically: frames, raw depths, ray-value
    arrays and interpolation frames agree to 1e-5."""
    train_cfg = write_config(tmp_path / "train.yaml", tmp_path / "Results",
                             tasks_to_perform={"start_training": True})
    trained = jrunner.Runner(train_cfg)
    trained.start()
    cfg = write_config(tmp_path / "render.yaml", tmp_path / "Results",
                       tasks_to_perform=RENDER_TASKS, existing_save_dir_name=trained.save_dir.name,
                       starting_epoch_number=1)
    ref = _render_all(monkeypatch, jrunner, jrunner.Runner(cfg), jimage_ops, jplots, jvideo)
    got = _render_all(monkeypatch, trunner, trunner.Runner(cfg, device="cpu"), timage_ops,
                      tplots, tvideo)

    names = [Path(a[0]).name for a in ref["frames"]]
    assert [Path(a[0]).name for a in got["frames"]] == names
    assert names == [jvideo.FILENAME_RGB_L_TO_R, jvideo.FILENAME_DEPTH_L_TO_R,
                     jvideo.FILENAME_RGB_SPHERE, jvideo.FILENAME_DEPTH_SPHERE,
                     jvideo.FILENAME_RGB_PATH, jvideo.FILENAME_DEPTH_PATH,
                     jvideo.FILENAME_TRAIN_SET]
    for (name, a), b in zip(zip(names, got["frames"]), ref["frames"]):
        assert len(a[1]) == len(b[1]) and a[2] == b[2], name
        if "depths" in name:  # equalized: compared through the raw depths below
            continue
        for fa, fb in zip(a[1], b[1]):
            np.testing.assert_allclose(np.asarray(fa), np.asarray(fb), atol=ATOL, rtol=0,
                                       err_msg=name)
    n_frames = sum(len(a[1]) for name, a in zip(names, ref["frames"]) if "rgb" in name)
    assert len(got["depth"]) == len(ref["depth"]) == n_frames
    for a, b in zip(got["depth"], ref["depth"]):
        np.testing.assert_allclose(a[0], np.asarray(b[0]), atol=ATOL, rtol=0)
    assert [a[0] for a in got["plot_video"]] == [a[0] for a in ref["plot_video"]]

    (a,), (b,) = got["rays"], ref["rays"]
    np.testing.assert_array_equal(a[2], b[2])  # the three pixels
    assert a[7] == b[7] == 1
    for x, y in zip(a[1:2] + a[3:7], b[1:2] + b[3:7]):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=ATOL, rtol=0)
    (a,), (b,) = got["interp"], ref["interp"]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    assert len(a[3]) == len(b[3]) == 16
    for x, y in zip(a[3], b[3]):
        np.testing.assert_allclose(x, np.asarray(y), atol=ATOL, rtol=0)


PATHS = ("l_to_r_path_matrices", "sphere_path_matrices", "waypoint_path_matrices")


@pytest.mark.parametrize("kind", ["parallel_colmap", "parallel_blender", "ring"])
def test_camera_paths_equal_jax(kind):
    """The three video paths, from numpy pose math: the spherical branch (a
    ring of cameras), the other branch, and its Blender case for the sphere."""
    jds, tds = ring_scene() if kind == "ring" else scene()
    run_kw = dict(dataset_type="blender" if kind == "parallel_blender" else "colmap",
                  test_img_idx=1)
    video_kw = dict(fps_render_video=3, img_indices_for_path_video=[0, 2, 3])
    for name in PATHS:
        ref = getattr(jrunner.Runner, name)(types.SimpleNamespace(
            run=jconfig.RunConfig(**run_kw, video=jconfig.VideoConfig(**video_kw)),
            dataset=jds))
        got = getattr(trunner.Runner, name)(types.SimpleNamespace(
            run=tconfig.RunConfig(**run_kw, video=tconfig.VideoConfig(**video_kw)),
            dataset=tds))
        assert got.shape == ref.shape and len(got) > 0
        np.testing.assert_array_equal(got, ref)
    from nerf_and_dietnerf_tpu_torch.core import pose_math

    spherical = pose_math.estimate_point_of_interest(tds.camera_poses)[1]
    assert spherical == (kind == "ring")


def test_image_ops_equal_jax():
    rng = np.random.default_rng(0)
    for image in (rng.uniform(size=(12, 9)), rng.uniform(size=(12, 9, 3)) ** 2,
                  np.zeros((5, 5))):
        got, ref = timage_ops.histogram_equalize(image), jimage_ops.histogram_equalize(image)
        for a, b in zip(got, ref):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
    rgb = rng.uniform(size=(4, 4, 3))
    np.testing.assert_array_equal(timage_ops.rgb2yiq(rgb), jimage_ops.rgb2yiq(rgb))
    np.testing.assert_array_equal(timage_ops.yiq2rgb(rgb), jimage_ops.yiq2rgb(rgb))


def test_ray_rebinning_equals_jax():
    rng = np.random.default_rng(1)
    z = np.sort(rng.uniform(0.5, 3.0, (3, 12)), -1)
    arrays = (rng.uniform(size=(3, 12)), rng.uniform(size=(3, 12)), rng.uniform(size=(3, 12)),
              rng.uniform(size=(3, 12, 3)))
    for a, b in zip(tplots.rebin_ray_samples(5, z, *arrays),
                    jplots.rebin_ray_samples(5, z, *arrays)):
        np.testing.assert_array_equal(a, b)
    maps = [rng.uniform(size=(6, 7, 4)) for _ in range(2)]
    coords = np.asarray([[1, 2], [5, 6]])
    for a, b in zip(tplots.slice_out_rays(coords, *maps), jplots.slice_out_rays(coords, *maps)):
        np.testing.assert_array_equal(a, b)


def test_plot_video_excludes_unnumbered_snapshot(tmp_path):
    """Only the numbered epoch plots make the plot video: the unnumbered
    test_img.jpg snapshot would mis-size the writer (reference filter:
    src/UtilsPlots.py:15,206-218)."""
    import cv2

    plots_dir = tmp_path / "plot_iteration_images"
    plots_dir.mkdir()
    small = np.zeros((20, 30, 3), np.uint8)
    big = np.full((60, 90, 3), 128, np.uint8)
    cv2.imwrite(str(plots_dir / "test_img.jpg"), small)  # must be excluded
    cv2.imwrite(str(plots_dir / "train_iteration_plots_001.jpg"), big)
    cv2.imwrite(str(plots_dir / "train_iteration_plots_002.jpg"), big)

    assert tvideo._numbered_images_in(plots_dir) == [
        "train_iteration_plots_001.jpg", "train_iteration_plots_002.jpg"
    ]
    out = tmp_path / "plots_video.avi"
    tvideo.save_plot_video(2, plots_dir, out, downscale=1.0)
    cap = cv2.VideoCapture(str(out))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 2
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == 90


def test_mismatched_frame_sizes_fail_loudly(tmp_path):
    """cv2 silently drops wrong-sized frames; the writer must raise."""
    frames = [np.zeros((8, 8, 3)), np.zeros((16, 8, 3))]
    with pytest.raises(ValueError, match="frame size"):
        tvideo.save_frames_as_video(tmp_path / "v.avi", frames, 2)


def test_make_save_dir(tmp_path):
    snapshot = tmp_path / "cfg.yaml"
    snapshot.write_text("neural_net: {}\n")
    cfg = tconfig.RunConfig(general_save_location=str(tmp_path / "R"), config_name="cfg")
    d0 = tconfig.make_save_dir(cfg, snapshot)
    d1 = tconfig.make_save_dir(cfg)
    assert (d0.name, d1.name) == ("cfg_save_dir_0", "cfg_save_dir_1")
    assert (d0 / "cfg.yaml").read_text() == snapshot.read_text()
    assert not (d1 / "cfg.yaml").exists()
    cfg.existing_save_dir_name = d0.name
    assert tconfig.make_save_dir(cfg, snapshot) == d0
    cfg.existing_save_dir_name = "cfg_save_dir_7"
    with pytest.raises(FileNotFoundError, match="cfg_save_dir_7"):
        tconfig.make_save_dir(cfg)
    assert sorted(p.name for p in (tmp_path / "R").iterdir()) == [d0.name, d1.name]


def test_epoch_callback_runs_after_each_epochs_h5(tmp_path):
    _, tds = scene()
    run = tconfig.RunConfig(
        hidden_layer_dim=16, last_hidden_layer_dim=8, n_pos_enc_dim_xyz=2, n_pos_enc_view_dir=2,
        n_render_samples_coarse=4, n_render_samples_fine=4, near_depth_render=0.5,
        far_depth_render=3.0, n_rays_in_batch_train=60, n_epochs=2, idx_train_img_to_plot=1,
        compute_dtype="float32")
    seen = []
    trainer = Trainer(run, tds, tmp_path, device="cpu", epoch_callback=lambda t, s: seen.append(
        (t is trainer, s.epoch, tckpt.nerf_h5_path(tmp_path, s.epoch).exists(),
         len(t.psnrs_test))))
    trainer.fit(log=None)
    assert seen == [(True, 1, True, 1), (True, 2, True, 2)]


@pytest.mark.parametrize("writes", [True, False], ids=["rank0", "other_rank"])
def test_epoch_callback_renders_on_every_rank(monkeypatch, writes):
    """The eval renders are collectives over a group, so every rank takes
    them in the epoch callback, even if the per-epoch memo were empty; only
    the writing rank plots and backs up."""
    renders, written = [], []
    trainer = types.SimpleNamespace(
        render_eval_images=lambda epoch: renders.append(epoch) or {
            "train": (1, np.zeros((2, 2, 3))), "test": (0, np.zeros((2, 2, 3)))},
        psnrs_train=[1.0], psnrs_test=[1.0],
        data=types.SimpleNamespace(batches_per_epoch=1))
    runner = types.SimpleNamespace(
        writes=writes, save_dir=Path("unused"),
        dataset=types.SimpleNamespace(images=np.zeros((2, 2, 2, 3))),
        backup_to_gcp=lambda: written.append("backup"))
    monkeypatch.setattr(tplots, "save_epoch_plot", lambda *a: written.append("plot"))
    stats = types.SimpleNamespace(epoch=3, seconds=1.0, psnr_test=1.0)
    trunner.Runner._epoch_callback(runner, trainer, stats)
    assert renders == [3]
    assert written == (["plot", "backup"] if writes else [])


def test_backup_to_gcp_issues_the_jax_command(monkeypatch):
    calls = []
    for mod in (jrunner, trunner):
        monkeypatch.setattr(mod.subprocess, "run", lambda cmd, **kw: calls.append((cmd, kw)))
    for save_dir in ("Results/a_save_dir_0", "Results/a_save_dir_0_datetime_x"):
        for mod, cfg in ((jrunner, jconfig), (trunner, tconfig)):
            me = types.SimpleNamespace(
                run=cfg.RunConfig(google_cloud_bucket_name="gs://bucket/"),
                save_dir=Path(save_dir), datetime_start="2026-01-02_03-04-05")
            mod.Runner.backup_to_gcp(me)
            me.run.google_cloud_bucket_name = None
            mod.Runner.backup_to_gcp(me)  # no bucket: no call
    assert len(calls) == 4
    assert calls[0] == calls[1] and calls[2] == calls[3]
    assert calls[0][0] == ["gsutil", "-m", "rsync", "-r", "Results/a_save_dir_0",
                           "gs://bucket/Results/a_save_dir_0_datetime_2026-01-02_03-04-05"]
    assert calls[2][0][-1] == "gs://bucket/Results/a_save_dir_0_datetime_x"


def test_main_runs_every_task_on_the_cpu(tmp_path, datasets):
    cfg = write_config(tmp_path / "cli.yaml", tmp_path / "unused")
    assert tmain.main([str(cfg), "--save-root", str(tmp_path / "R"), "--platform", "cpu"]) == 0
    save = tmp_path / "R" / "cli_save_dir_0"
    assert (save / "cli.yaml").exists()
    assert (save / "saved_weights" / "NeRF_model_epoch_001.h5").exists()
    assert (save / tplots.PLOT_ITERATION_DIRNAME / "train_iteration_plots_001.jpg").exists()
    assert len(list((save / trunner.VIDEOS_DIRNAME).glob("*.avi"))) == 8
    assert (save / tplots.SPECIAL_PLOTS_DIRNAME / "interpolation_between_2_images.jpg").exists()


def write_blender_scene(directory: Path) -> None:
    """``scene()``'s images as 8-bit PNGs with a ``cam_data.json``: a dataset
    that ranks spawned by ``main`` load from disk (the ``datasets`` fixture's
    patch does not reach them)."""
    import imageio.v2 as imageio

    _, tds = scene()
    directory.mkdir(parents=True)
    frames = []
    for i, (img, c2w) in enumerate(zip(tds.images, tds.camera_poses)):
        imageio.imwrite(directory / f"img_{i}.png", (img * 255).round().astype(np.uint8))
        frames.append({"filename": f"img_{i}.png", "transformation_matrix": c2w.tolist()})
    (directory / "cam_data.json").write_text(json.dumps(
        {"focal_length": 50.0, "field_of_view": tds.field_of_view, "frames": frames}))


@pytest.mark.parametrize("change,flags,env,rc,what", [
    ({"neural_net": {"type_of_model": "DietNeRF"}}, [], False, 1, "allow_random_embedder"),
    ({"mesh": {"data_devices": 2}}, [], False, 0, "data devices: 2 spawned ranks"),
    ({}, ["--data-devices", "2"], False, 0, "data devices: 2 spawned ranks"),
    ({}, ["--distributed"], True, 0, "data devices: 1 (rank 0)"),
], ids=["dietnerf", "data_devices_config", "data_devices_flag", "distributed"])
def test_main_refuses_what_is_not_ported(tmp_path, datasets, capsys, monkeypatch, change, flags,
                                         env, rc, what):
    """A DietNeRF config with neither --vit-weights nor allow_random_embedder
    fails as in the JAX package (the DietTrainer's ValueError about ViT
    weights) and writes no directory. Multi-GPU runs are ported: a config's
    ``data_devices: 2`` or ``--data-devices 2`` runs 2 spawned gloo CPU
    ranks, ``--distributed`` joins the launcher's group (here a world of
    one: the single-device run); each writes its artifacts into one save
    directory."""
    if env:
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(mesh_lib.free_port()))
    if rc == 0 and not env:
        write_blender_scene(tmp_path / "scene")
        change = dict(change, dataset_type="blender", dataset_location=str(tmp_path / "scene"))
    cfg = write_config(tmp_path / "no.yaml", tmp_path / "R", **change)
    assert tmain.main([str(cfg), "--platform", "cpu", *flags]) == rc
    out, err = capsys.readouterr()
    if rc:
        assert "ValueError" in err and what in err
        assert not (tmp_path / "R").exists()
        return
    assert what in out
    assert sorted(p.name for p in (tmp_path / "R").iterdir()) == ["no_save_dir_0"]
    save = tmp_path / "R" / "no_save_dir_0"
    assert (save / "saved_weights" / "NeRF_model_epoch_001.h5").exists()
    assert len(list((save / trunner.VIDEOS_DIRNAME).glob("*.avi"))) == 8


def test_main_needs_a_gpu_unless_told_cpu(tmp_path, datasets, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would train on it")
    cfg = write_config(tmp_path / "gpu.yaml", tmp_path / "R")
    assert tmain.main([str(cfg)]) == 1
    assert "device='cpu'" in capsys.readouterr().err


def test_resume_equivalence_exact(tmp_path, monkeypatch):
    """4 epochs straight through the runner equal, bitwise, 2 epochs and a
    second runner resuming the save directory (``existing_save_dir_name``,
    ``starting_epoch_number: 2``) for 2 more: parameters and PSNR histories.
    Constant lr, so the schedule's length does not enter."""
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(3, 12, 12, 3)).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 3)
    poses[:, 2, 3] = [2.0, 2.2, 2.4]
    ds = TDataset(images=images, camera_poses=poses, field_of_view=0.8, near=0.5, far=3.0,
                  average_c2w_before_recenter=np.eye(4), scale=1.0)
    monkeypatch.setattr(trunner.loaders, "load_dataset", lambda *a, **k: ds)
    common = dict(tasks_to_perform={"start_training": True},
                  neural_net={"n_rays_in_batch_train": 72, "n_rays_in_batch_render": 144})

    def run(name, **training):
        cfg = write_config(tmp_path / f"{name}.yaml", tmp_path / "R", **common, **training)
        runner = trunner.Runner(cfg, device="cpu")
        runner.start()
        return runner

    straight = run("straight", training={"n_epochs": 4})
    first = run("split", training={"n_epochs": 2})
    resumed = run("split_resume", training={"n_epochs": 4}, starting_epoch_number=2,
                  existing_save_dir_name=first.save_dir.name)
    assert resumed.save_dir == first.save_dir
    hist = [np.load(tckpt.psnr_path(r.save_dir, 4)) for r in (straight, resumed)]
    assert hist[0].shape == (2, 4)
    np.testing.assert_array_equal(hist[0], hist[1])
    a, b = tree_leaves(straight._params), tree_leaves(resumed._params)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], tree_leaves(first._params)[0])


def test_runner_backend_and_render_config(tmp_path, datasets):
    """The render config is the JAX runner's: f32, fusions off, the config's
    backend and the loader's bounds."""
    cfg = write_config(tmp_path / "rc.yaml", tmp_path / "R", mesh={"backend": "pallas"})
    ref = jrunner.Runner(cfg).render_config
    got = trunner.Runner(cfg, device="cpu").render_config
    assert got.compute_dtype == torch.float32 and ref.compute_dtype == jax.numpy.float32
    for field in ("backend", "fuse_compositing", "fuse_fine_loss", "near", "far",
                  "n_samples_coarse", "n_samples_fine"):
        assert getattr(got, field) == getattr(ref, field), field
