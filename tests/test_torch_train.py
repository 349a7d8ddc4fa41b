"""Port vs JAX package: Adam, the trainer, checkpoints, configs, and the port's
import and device rules."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.models import nerf as jn
from nerf_and_dietnerf_tpu.train import train_step as jts
from nerf_and_dietnerf_tpu.utils import config as jconfig
from nerf_and_dietnerf_tpu_torch.data.loaders import Dataset
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.models import nerf as tn
from nerf_and_dietnerf_tpu_torch.train import checkpoint as tckpt
from nerf_and_dietnerf_tpu_torch.train import train_step as tts
from nerf_and_dietnerf_tpu_torch.train.trainer import Trainer
from nerf_and_dietnerf_tpu_torch.utils import config as tconfig
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
MLP = dict(hidden_dim=16, last_hidden_dim=8, n_freq_xyz=2, n_freq_dir=2, n_angles=2)


@pytest.mark.parametrize("schedule", [False, True], ids=["constant_lr", "decay_and_clip"])
def test_three_adam_steps_match_optax(schedule):
    common = dict(n_samples_coarse=6, n_samples_fine=6, backend="xla")
    jcfg = jn.NeRFConfig(mlp=jm.MLPConfig(**MLP), compute_dtype=jnp.float32, **common)
    tcfg = tn.NeRFConfig(mlp=tm.MLPConfig(**MLP), compute_dtype=torch.float32, **common)
    if schedule:
        # clip at a norm the first steps exceed, so the clip really fires
        kw = dict(lr_final=5e-5, total_steps=3, grad_clip_norm=1e-3)
    else:
        kw = {}
    jopt = jts.make_optimizer_with_schedule(5e-3, **kw)
    topt = tts.make_optimizer_with_schedule(5e-3, **kw)
    jp = jn.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tm.params_from_jax(jp)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(0)
    for _ in range(3):
        orig = np.concatenate([rng.normal(size=(16, 3)) * 0.2, np.ones((16, 1))], -1)
        dirs = np.concatenate([rng.normal(size=(16, 3)) * 0.3 + [0, 0, 1], np.zeros((16, 1))], -1)
        rgb = rng.uniform(size=(16, 3))
        z_c = np.sort(rng.uniform(2, 6, (16, 6)), -1)
        z_f = np.sort(rng.uniform(2, 6, (16, 6)), -1)
        b = [a.astype(np.float32) for a in (orig, dirs, rgb, z_c, z_f)]
        jg = jax.grad(lambda p: jn.training_losses_fixed_z(p, jcfg, *b))(jp)
        updates, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        _, _, tg = tts.loss_and_grads(
            tp, lambda p: (tn.training_losses_fixed_z(p, tcfg, *map(torch.tensor, b)), None))
        tupd, tstate = topt.update(tg, tstate)
        tp = tts.apply_updates(tp, tupd)
    assert tstate["count"] == 3
    # Adam divides by sqrt(nu): where a gradient is near 0 its update is
    # sensitive to the gradient's last bits, so the params are held to a
    # hundredth of the first step's size (lr) and the moments closely.
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=0)
    ref = [m for m in jax.tree.leaves(jstate) if np.ndim(m) > 0]  # mu leaves, then nu
    got = tree_leaves(tstate["mu"]) + tree_leaves(tstate["nu"])
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        scale = max(1e-12, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(b) / scale, atol=1e-4)


def synthetic_dataset(n=4, h=10, w=10):
    """The tiny scene of tests/test_runner.py."""
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * n)
    poses[:, 2, 3] = 2.0 + 0.2 * np.arange(n)
    poses[:, 0, 3] = 0.1 * np.arange(n)
    return Dataset(images=images, camera_poses=poses, field_of_view=0.8, near=0.5, far=3.0,
                   average_c2w_before_recenter=np.eye(4), scale=1.0)


def tiny_run(**kw):
    """The tiny config of tests/test_runner.py (hidden 16, 4 + 4 samples)."""
    base = dict(
        dataset_type="colmap", hidden_layer_dim=16, last_hidden_layer_dim=8,
        n_pos_enc_dim_xyz=2, n_pos_enc_view_dir=2, n_angles_for_model=2,
        n_rays_in_batch_train=60, n_rays_in_batch_render=100, n_render_samples_coarse=4,
        n_render_samples_fine=4, near_depth_render=0.5, far_depth_render=3.0, n_epochs=1,
        optimizer_lr=5e-4, test_img_idx=0, idx_train_img_to_plot=1, compute_dtype="float32",
        backend="pallas",
    )
    base.update(kw)
    return tconfig.RunConfig(**base)


def test_trainer_one_epoch_on_cpu_writes_artifacts(tmp_path):
    trainer = Trainer(tiny_run(), synthetic_dataset(), tmp_path, device="cpu")
    assert trainer.data.batches_per_epoch == 5  # 3 train views x 100 rays / 60
    history = trainer.fit(log=None)
    assert len(history) == 1 and np.isfinite(history[0].loss)
    assert np.isfinite(history[0].psnr_test) and np.isfinite(history[0].psnr_train)
    assert tckpt.nerf_h5_path(tmp_path, 1).exists()
    test, train = np.load(tckpt.psnr_path(tmp_path, 1))
    assert test.shape == train.shape == (1,)
    assert trainer.state.step == 5 and trainer.state.opt_state["count"] == 5
    assert trainer.ckpt.latest_step() == 1


@pytest.mark.parametrize("n_angles", [2, 0], ids=["view_dirs", "xyz_only"])
def test_trainer_pallas_rm_one_epoch_on_cpu(tmp_path, n_angles):
    """The fused ray-march backend through the trainer (its plain versions on
    the CPU): a finite loss and eval renders of the frame's shape."""
    run = tiny_run(backend="pallas_rm", n_angles_for_model=n_angles)
    trainer = Trainer(run, synthetic_dataset(), tmp_path, device="cpu")
    assert trainer.config.backend == trainer.eval_config.backend == "pallas_rm"
    stats = trainer.train_epoch(1)
    assert np.isfinite(stats.loss) and np.isfinite(stats.psnr_test)
    for idx, rgb in trainer.render_eval_images(1).values():
        assert rgb.shape == (10, 10, 3) and np.isfinite(rgb).all()


@pytest.mark.parametrize("kw,what", [({"type_of_model": "DietNeRF"}, "DietNeRF"),
                                     ({"mesh_data_devices": 2}, "multi-GPU")],
                         ids=["dietnerf", "data_devices_2"])
def test_trainer_refuses_configs_it_cannot_train(tmp_path, kw, what):
    """A DietNeRF config, or one on two data devices, goes to DietTrainer or a
    device mesh in the JAX runner; the port's Trainer refuses both rather
    than train plain single-device NeRF."""
    with pytest.raises(NotImplementedError, match=what):
        Trainer(tiny_run(**kw), synthetic_dataset(), tmp_path, device="cpu")
    Trainer(tiny_run(mesh_data_devices=1), synthetic_dataset(), tmp_path, device="cpu")


def test_eval_config_turns_train_fusions_off(tmp_path, monkeypatch):
    """As in the JAX package, eval renders run in f32 without the train-path
    fusions, whatever the train config (no YAML key sets fuse_compositing)."""
    nerf_config = tconfig.RunConfig.nerf_config
    monkeypatch.setattr(tconfig.RunConfig, "nerf_config", lambda self: dataclasses.replace(
        nerf_config(self), fuse_compositing=True))
    trainer = Trainer(tiny_run(backend="pallas_rm", compute_dtype="bfloat16"),
                      synthetic_dataset(), tmp_path, device="cpu")
    assert trainer.config.fuse_compositing and trainer.config.compute_dtype == torch.bfloat16
    ev = trainer.eval_config
    assert not ev.fuse_compositing and not ev.fuse_fine_loss
    assert ev.compute_dtype == torch.float32 and ev.backend == "pallas_rm"
    assert np.isfinite(trainer.train_epoch(1).loss)  # the train steps go through B7


def test_h5_resume_fast_forwards_the_optimizer_count(tmp_path):
    first = Trainer(tiny_run(), synthetic_dataset(), tmp_path, device="cpu")
    first.fit(log=None)
    for f in (tmp_path / "states").iterdir():  # leave only the .h5 weights
        f.unlink()
    resumed = Trainer(tiny_run(starting_epoch_number=1, n_epochs=2), synthetic_dataset(),
                      tmp_path, device="cpu")
    assert resumed.start_epoch == 1
    assert resumed.state.step == 5 and resumed.state.opt_state["count"] == 5
    assert all(float(m.abs().max()) == 0 for m in tree_leaves(resumed.state.opt_state["mu"]))
    for a, b in zip(tree_leaves(resumed.state.params), tree_leaves(first.state.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(resumed.psnrs_test) == 1
    resumed.fit(log=None)
    assert resumed.state.opt_state["count"] == 10


def test_full_state_checkpoint_round_trip(tmp_path):
    trainer = Trainer(tiny_run(), synthetic_dataset(), tmp_path, device="cpu")
    trainer.train_epoch(1)
    trainer.ckpt.save(1, trainer.state)
    back = tckpt.CheckpointManager(tmp_path / "states").restore()
    assert back.step == trainer.state.step and back.opt_state["count"] == 5
    for part in ("params", "opt_state"):
        got, ref = tree_leaves(getattr(back, part)), tree_leaves(getattr(trainer.state, part))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            if isinstance(a, torch.Tensor):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            else:
                assert a == b


CONFIGS = sorted((ROOT / "config_files").rglob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_stock_yamls_load_like_jax(path):
    got, ref = tconfig.load_config(path), jconfig.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.VALID_BACKENDS == ref.VALID_BACKENDS
    ncfg = got.nerf_config()
    assert ncfg.mlp == tm.MLPConfig(**dataclasses.asdict(ref.nerf_config().mlp))
    assert ncfg.backend == ref.nerf_config().backend


def test_config_rejects_unknown_keys(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("neural_net:\n  hiden_layer_dim: 3\n")
    with pytest.raises(ValueError, match="hiden_layer_dim"):
        tconfig.load_config(bad)


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.path.insert(0, %r)\n"
        "import nerf_and_dietnerf_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('nerf_and_dietnerf_tpu.') or m == 'nerf_and_dietnerf_tpu'\n"
        "       or m in ('optax', 'orbax', 'yaml', 'h5py', 'imageio', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "new = ['ops.probe_kernels_cuda', 'utils.profiling', 'tools', 'tools.exp_mxu',\n"
        "       'tools.exp_vpu', 'tools.exp_interleave', 'tools.exp_expand', 'tools.exp_enccost']\n"
        "missing = [m for m in new if 'nerf_and_dietnerf_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "assert 'tools' not in sys.modules, 'the root tools/ directory was imported'\n"
        "print(len([m for m in sys.modules if m.startswith('nerf_and_dietnerf_tpu_torch')]))\n"
    ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 23


def test_entry_points_need_cuda_unless_told_cpu(tmp_path):
    c2w = np.eye(4, dtype=np.float32)
    cfg = tn.NeRFConfig(mlp=tm.MLPConfig(**MLP), n_samples_coarse=2, n_samples_fine=2)
    params = tn.init_params(torch.Generator().manual_seed(0), cfg)
    if torch.cuda.is_available():
        trainer = Trainer(tiny_run(), synthetic_dataset(), tmp_path)
        assert trainer.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(tiny_run(), synthetic_dataset(), tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tn.render_image(params, cfg, None, c2w, 0.7, 2, 2)
    result, _ = tn.render_image(params, cfg, None, c2w, 0.7, 2, 2, device="cpu")
    assert result.rgb.shape == (2, 2, 3)
