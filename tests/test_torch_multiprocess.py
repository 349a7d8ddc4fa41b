"""Real multi-process runs of the port: 2 gloo CPU ranks over
``torch.distributed``, the counterpart of tests/test_multiprocess.py and
tests/test_dietnerf.py::test_diet_sharded_epoch_matches_single.

Each rank is its own OS process (the port's worker,
``nerf_and_dietnerf_tpu_torch.tools.multiprocess_worker``, or ``main``):
- the two ranks hold bitwise equal parameters and log equal metrics;
- their epochs match a one-process run of the same seeds (rtol 1e-5: f32,
  the gradient's sum over rows grouped by rank);
- fresh processes resume from rank 0's checkpoint and match the straight
  run's epoch 3; exactly one save directory exists (rank 0's, broadcast);
- ``main --data-devices 2`` and two ``main --distributed`` processes write the
  JAX runner's artifact names;
- DietNeRF on two ranks matches one process after an epoch (params 1e-5,
  the JAX package's own bound).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import yaml

from nerf_and_dietnerf_tpu.tasks import runner as jrunner
from nerf_and_dietnerf_tpu_torch import main as tmain
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib
from nerf_and_dietnerf_tpu_torch.train import checkpoint
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

REPO = Path(__file__).resolve().parent.parent
WORKER = "nerf_and_dietnerf_tpu_torch.tools.multiprocess_worker"
TIMEOUT = 120  # seconds a spawned process may take
RTOL = 1e-5


def _env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(REPO) + os.pathsep + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // world)))
    return env


def _launch(commands, world: int):
    """Run one command a rank, all at once; each must exit 0 in time."""
    port = mesh_lib.free_port()
    procs = [subprocess.Popen(cmd, env=_env(rank, world, port), cwd=str(REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank, cmd in enumerate(commands)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"
    return outputs


def _workers(out: Path, world: int, *args):
    out.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", WORKER, "--out", str(out), *args]
    _launch([cmd] * world, world)


def _load(out: Path, name: str) -> dict:
    with open(out / name) as f:
        return json.load(f)


def test_two_ranks_match_one_process_and_resume(tmp_path):
    # Two ranks train epochs 1-2, write their checkpoints and exit.
    _workers(tmp_path, 2, "--epochs", "2")
    r0, r1 = _load(tmp_path, "result_rank0.json"), _load(tmp_path, "result_rank1.json")
    assert r0["world_size"] == r1["world_size"] == 2 and r0["epochs"] == [1, 2]
    assert r0["rows_per_step"] == 32 and r0["latest_state"] == 2
    assert r0["losses"] == r1["losses"] and r0["psnr_test"] == r1["psnr_test"]
    assert r0["psnr_train"] == r1["psnr_train"]
    assert r0["params_sha256"] == r1["params_sha256"]
    assert r0["save_dir"] == r1["save_dir"] == "shared_run_save_dir_0"
    assert [p.name for p in tmp_path.iterdir() if p.is_dir()] == ["shared_run_save_dir_0"]

    # Fresh ranks resume from rank 0's files and train epoch 3.
    _workers(tmp_path, 2, "--epochs", "3", "--start-epoch", "2", "--save-dir", r0["save_dir"])
    s0, s1 = (_load(tmp_path, f"result_rank{r}_from2.json") for r in (0, 1))
    assert s0["epochs"] == [3] and s0["losses"] == s1["losses"]
    assert s0["params_sha256"] == s1["params_sha256"]

    # One process, straight through epochs 1-3.
    sp_dir = tmp_path / "sp"
    _workers(sp_dir, 1, "--epochs", "3")
    sp = _load(sp_dir, "result_sp.json")
    assert sp["epochs"] == [1, 2, 3] and sp["rows_per_step"] == 64
    np.testing.assert_allclose(r0["losses"], sp["losses"][:2], rtol=RTOL)
    np.testing.assert_allclose(r0["psnr_test"], sp["psnr_test"][:2], rtol=RTOL)
    np.testing.assert_allclose(s0["losses"], sp["losses"][2:], rtol=RTOL)
    np.testing.assert_allclose(s0["psnr_test"], sp["psnr_test"][2:], rtol=RTOL)
    hist = checkpoint.PSNR_DIRNAME, checkpoint.PSNR_FILENAME_FORMAT.format(3)
    np.testing.assert_allclose(np.load(tmp_path / r0["save_dir"] / hist[0] / hist[1]),
                               np.load(sp_dir / sp["save_dir"] / hist[0] / hist[1]), rtol=RTOL)


CLI_CONFIG = {
    "dataset_type": "blender",
    "tasks_to_perform": {"start_training": True,
                         "render_and_save_test_left_to_right_video": True,
                         "create_plots_that_visualize_values_along_rays": True},
    "neural_net": {"hidden_layer_dim": 16, "last_hidden_layer_dim": 8,
                   "n_pos_enc_dim_xyz": 2, "n_pos_enc_view_dir": 2,
                   "n_rays_in_batch_train": 60, "n_rays_in_batch_render": 100},
    "render": {"n_render_samples_coarse": 4, "n_render_samples_fine": 4,
               "near_depth_render": 0.5, "far_depth_render": 3.0},
    "training": {"n_epochs": 1, "test_img_idx": 0, "idx_train_img_to_plot": 1},
    "video": {"fps_render_video": 1},
    "mesh": {"compute_dtype": "float32"},
}


def _blender_scene(directory: Path) -> None:
    """tests/test_multiprocess.py's on-disk scene: random 10x10 PNGs and a
    ``cam_data.json``, so every rank's loader reads the same files."""
    import imageio.v2 as imageio

    directory.mkdir()
    rng = np.random.default_rng(1)
    frames = []
    for i in range(4):
        imageio.imwrite(directory / f"img_{i}.png",
                        (rng.uniform(size=(10, 10, 3)) * 255).astype(np.uint8))
        c2w = np.eye(4)
        c2w[2, 3] = 2.0 + 0.2 * i
        c2w[0, 3] = 0.1 * i
        frames.append({"filename": f"img_{i}.png", "transformation_matrix": c2w.tolist()})
    (directory / "cam_data.json").write_text(json.dumps(
        {"focal_length": 50.0, "field_of_view": 0.8, "frames": frames}))


def _artifacts(save_dir: Path):
    return sorted(str(p.relative_to(save_dir)) for p in save_dir.rglob("*")
                  if p.is_file() and p.relative_to(save_dir).parts[0] not in ("orbax", "states"))


def test_cli_data_devices_and_distributed(tmp_path):
    """``main --platform cpu --data-devices 2`` spawns two gloo ranks; two
    ``main --distributed`` processes join the group of the launcher's
    variables. Each returns 0 and writes the JAX runner's artifact names into
    one save directory."""
    _blender_scene(tmp_path / "scene")
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(dict(CLI_CONFIG, dataset_location=str(tmp_path / "scene"),
                                       general_save_location=str(tmp_path / "unused"))))
    jrunner.Runner(cfg, save_root=str(tmp_path / "jax")).start()
    want = _artifacts(tmp_path / "jax" / "tiny_save_dir_0")
    assert "saved_weights/NeRF_model_epoch_001.h5" in want

    spawned = tmp_path / "spawned"
    assert tmain.main([str(cfg), "--platform", "cpu", "--data-devices", "2",
                       "--save-root", str(spawned)]) == 0
    launched = tmp_path / "launched"
    cmd = [sys.executable, "-m", "nerf_and_dietnerf_tpu_torch.main", str(cfg), "--distributed",
           "--platform", "cpu", "--save-root", str(launched)]
    outputs = _launch([cmd, cmd], 2)
    assert all("data devices: 2 (rank" in out for out in outputs)
    for root in (spawned, launched):
        assert [p.name for p in root.iterdir()] == ["tiny_save_dir_0"]
        assert _artifacts(root / "tiny_save_dir_0") == want
    # Both groups trained the same global batches: equal weights.
    load = (lambda root: checkpoint.load_keras_h5(
        root / "tiny_save_dir_0" / "saved_weights" / "NeRF_model_epoch_001.h5",
        tm.MLPConfig(hidden_dim=16, last_hidden_dim=8, n_freq_xyz=2, n_freq_dir=2)))
    for a, b in zip(tree_leaves(load(spawned)), tree_leaves(load(launched))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_two_rank_dietnerf_matches_one_process(tmp_path):
    """The DietTrainer on two ranks (the tiny embedder, a diet step every
    3rd step: the consistency term computed whole on each rank) against one
    process after one epoch."""
    _workers(tmp_path, 2, "--epochs", "1", "--diet", "tiny")
    r0, r1 = _load(tmp_path, "result_rank0.json"), _load(tmp_path, "result_rank1.json")
    assert r0["losses"] == r1["losses"] and r0["params_sha256"] == r1["params_sha256"]
    sp_dir = tmp_path / "sp"
    _workers(sp_dir, 1, "--epochs", "1", "--diet", "tiny")
    sp = _load(sp_dir, "result_sp.json")
    assert sp["steps_per_epoch"] == r0["steps_per_epoch"] == 9
    np.testing.assert_allclose(r0["losses"], sp["losses"], rtol=RTOL)
    config = tm.MLPConfig(hidden_dim=16, last_hidden_dim=8, n_freq_xyz=2, n_freq_dir=2)
    weights = "saved_weights/NeRF_model_epoch_001.h5"
    two = checkpoint.load_keras_h5(tmp_path / r0["save_dir"] / weights, config)
    one = checkpoint.load_keras_h5(sp_dir / sp["save_dir"] / weights, config)
    for a, b in zip(tree_leaves(two), tree_leaves(one)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
