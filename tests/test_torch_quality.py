"""Port vs JAX package: training quality.

The lockstep: on ``chip_smoke.quality_scene`` (the scene the card's quality
phase trains, here at 24x24), the JAX package's "xla" train step and the
port's "xla" and "pallas" steps (the port's plain versions of B1 and B2 on
the CPU) start from JAX's initial weights and take the same ray batches, with
the port fed the uniforms JAX draws from each step's key; every
``EVAL_EVERY`` steps each renders the held-out views deterministically
(``key=None``) and scores their pooled MSE. JAX's held-out PSNR must rise, and
the port must track JAX's loss and held-out PSNR at every step and eval point.

Then the committed weights: both packages load the JAX-trained
``runs/256px_alexander_nerf_r04/NeRF_model_epoch_070.h5`` (flagship widths)
and render rays of radius-4 poses deterministically in f32.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nerf_and_dietnerf_tpu.core import rendering as jrend
from nerf_and_dietnerf_tpu.core import sampling as jsam
from nerf_and_dietnerf_tpu.data import pipeline as jpipe
from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.models import nerf as jn
from nerf_and_dietnerf_tpu.train import checkpoint as jckpt
from nerf_and_dietnerf_tpu.train import train_step as jts
from nerf_and_dietnerf_tpu_torch.core import cameras as tcam
from nerf_and_dietnerf_tpu_torch.data import pipeline as tpipe
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.models import nerf as tn
from nerf_and_dietnerf_tpu_torch.train import checkpoint as tckpt
from nerf_and_dietnerf_tpu_torch.train import train_step as tts
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent

# The lockstep's config, chosen on the JAX side alone (seed 0) so that JAX
# leaves the early grey plateau within the budget.
MLP = dict(hidden_dim=64, last_hidden_dim=32, n_freq_xyz=5, n_freq_dir=4, n_angles=2)
SIZE, VIEWS, RAYS, N_C, N_F, LR, SEED = 24, 48, 256, 32, 32, 1e-3, 0
STEPS, EVAL_EVERY = 150, 30
# Torch's CPU sums split over its threads, so the port's last bits (and, over
# a long run, its trajectory) depend on their number: fixed for the lockstep,
# at 2, which also keeps the test to its share of cores beside other workers.
THREADS = 2
# (a) JAX's held-out PSNR rises at least this much from init to the last step.
JAX_RISE_DB = 5.0
# (b) The port against JAX. Two f32 evaluations of this objective part within
# a few steps: the inverse CDF turns a last-place change of a coarse weight
# into a moved fine sample, the resampling's z gradient sums terms that
# cancel, and Adam's first steps turn a tiny gradient's sign into a whole
# step. JAX against itself, from weights moved by one ulp or on the batch's
# rows reordered (7 runs each, this config), reads at most 6.1e-8 at step 0,
# 3.4e-3 at steps 1-2, 0.20 at steps 3-29 and 0.93 after, and its held-out
# PSNR parts by up to 3.07 dB (tests/quality_controls.py). The loss tolerance,
# relative, by step: (first step past the range, tolerance).
LOSS_RTOL = ((1, 1e-5), (3, 1e-2), (30, 0.3), (None, 1.0))
# The held-out PSNR window at every eval point, dB.
PSNR_WINDOW_DB = 3.5


def _loss_rtol(step):
    return next(tol for end, tol in LOSS_RTOL if end is None or step < end)


def _psnr(mses):
    return float(-10 * np.log10(np.mean(mses)))


@pytest.fixture(scope="module")
def lockstep():
    """The three curves: per-step losses and held-out PSNRs at the eval
    points, for "jax", "xla" and "pallas"."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        return _run_lockstep()
    finally:
        torch.set_num_threads(threads)


def _run_lockstep():
    ds = chip_smoke.quality_scene(VIEWS, SIZE)
    held = chip_smoke.quality_held_out(VIEWS)
    train = [i for i in range(VIEWS) if i not in held]
    table = jpipe.build_ray_table(ds.images[train], ds.camera_poses[train], ds.field_of_view)
    for a, b in zip(table, tpipe.build_ray_table(ds.images[train], ds.camera_poses[train],
                                                 ds.field_of_view)):
        np.testing.assert_allclose(b, a, atol=1e-6)

    common = dict(n_samples_coarse=N_C, n_samples_fine=N_F, near=ds.near, far=ds.far)
    jcfg = jn.NeRFConfig(mlp=jm.MLPConfig(**MLP), compute_dtype=jnp.float32, backend="xla",
                         **common)
    jopt = jts.make_optimizer_with_schedule(LR)
    jstate = jts.init_train_state(jax.random.PRNGKey(SEED), jcfg, jopt)
    jstep = jax.jit(functools.partial(jts.train_step, config=jcfg, optimizer=jopt))
    jrender = jax.jit(lambda p, c2w: jn.render_image(
        p, jcfg, None, c2w, ds.field_of_view, SIZE, SIZE, chunk_size=SIZE * SIZE,
        diagnostics=False)[0].rgb)

    @jax.jit
    def jax_draws(key):
        """What JAX's training_losses draws from ``key``, in its order."""
        k_strat, k_res, _, _ = jax.random.split(key, 4)
        return (jax.random.uniform(k_strat, (RAYS, N_C)),
                jsam.sorted_uniforms(k_res, (RAYS,), N_F))

    backends = ("xla", "pallas")
    tcfg = {b: tn.NeRFConfig(mlp=tm.MLPConfig(**MLP), compute_dtype=torch.float32, backend=b,
                             **common) for b in backends}
    topt = tts.make_optimizer_with_schedule(LR)
    params = tm.params_from_jax(jstate.params)
    tstate = {b: tts.TrainState(params, topt.init(params), 0) for b in backends}

    def held_out_psnrs():
        out = {"jax": _psnr([float(jnp.mean(jnp.square(jrender(jstate.params, ds.camera_poses[i])
                                                       - ds.images[i]))) for i in held])}
        for b in backends:
            out[b] = _psnr([float(np.mean(np.square(tn.render_image(
                tstate[b].params, tcfg[b], None, ds.camera_poses[i], ds.field_of_view, SIZE,
                SIZE, chunk_size=SIZE * SIZE, diagnostics=False, device="cpu")[0].rgb.numpy()
                - ds.images[i]))) for i in held])
        return out

    curves = {"loss": {k: [] for k in ("jax",) + backends},
              "psnr": {k: [] for k in ("jax",) + backends}, "eval_steps": []}
    rng = np.random.default_rng(SEED)
    n_batches = table[0].shape[0] // RAYS
    for step in range(STEPS + 1):
        if step % EVAL_EVERY == 0:
            curves["eval_steps"].append(step)
            for k, v in held_out_psnrs().items():
                curves["psnr"][k].append(v)
        if step == STEPS:
            break
        if step % n_batches == 0:
            perm = rng.permutation(table[0].shape[0])
        idx = perm[(step % n_batches) * RAYS:(step % n_batches + 1) * RAYS]
        key = jax.random.fold_in(jax.random.PRNGKey(SEED + 1), step)
        jstate, metrics = jstep(jstate, key, tuple(t[idx] for t in table))
        curves["loss"]["jax"].append(float(metrics["loss"]))
        strat_u, fine_u = jax_draws(key)
        draws = {"strat_u": torch.tensor(np.asarray(strat_u)),
                 "fine_u": torch.tensor(np.asarray(fine_u))}
        batch = tuple(torch.tensor(t[idx]) for t in table)
        for b in backends:
            tstate[b], metrics = tts.train_step(tstate[b], None, batch, config=tcfg[b],
                                                optimizer=topt, draws=draws)
            curves["loss"][b].append(float(metrics["loss"]))
    return curves


def test_jax_held_out_psnr_rises_on_the_quality_scene(lockstep):
    """The scene and the step count against the reference: JAX's own held-out
    PSNR rises by JAX_RISE_DB."""
    psnr = lockstep["psnr"]["jax"]
    print("JAX held-out PSNR:", dict(zip(lockstep["eval_steps"], np.round(psnr, 3))))
    assert psnr[-1] - psnr[0] >= JAX_RISE_DB, psnr


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_port_trains_in_lockstep_with_jax(lockstep, backend):
    """The port's loss within LOSS_RTOL of JAX's at every step, and its
    held-out PSNR within PSNR_WINDOW_DB of JAX's at every eval point."""
    ref, got = np.array(lockstep["loss"]["jax"]), np.array(lockstep["loss"][backend])
    rel = np.abs(got - ref) / ref
    tol = np.array([_loss_rtol(s) for s in range(len(ref))])
    gaps = np.abs(np.array(lockstep["psnr"][backend]) - np.array(lockstep["psnr"]["jax"]))
    worst = int(np.argmax(rel / tol))
    print(f"{backend}: loss rel gap, largest against its tolerance at step {worst}: "
          f"{rel[worst]:.3e} (tol {tol[worst]}); largest {rel.max():.3e} at step "
          f"{int(rel.argmax())}; held-out PSNR gaps (dB) "
          f"{dict(zip(lockstep['eval_steps'], np.round(gaps, 3)))}")
    bad = np.flatnonzero(rel > tol)
    assert bad.size == 0, [(int(s), float(rel[s]), float(tol[s])) for s in bad]
    assert gaps.max() <= PSNR_WINDOW_DB, gaps


# The card's quality phase (chip_smoke.quality_phase), without a card: each
# path's exact launches and what its first step draws.
QUALITY_FUSED = ("pallas_rm_fused", "pallas_fused", "pallas_fused_loss")
QUALITY_STEPS, QUALITY_HELD = 168, 6  # quality_scene(48, 128): 168 steps an epoch, 6 held out


@pytest.mark.parametrize("path", QUALITY_FUSED)
def test_quality_fused_paths_train_with_the_fused_phase_changes(path):
    """Each bf16 fused path trains with FUSED_PATHS' own model-config changes
    and is held against "xla" in bf16."""
    change = chip_smoke.FUSED_PATHS[path]
    assert chip_smoke.QUALITY_PATHS[path] == (change["backend"], "bfloat16", "xla")
    assert chip_smoke._quality_fusions(path) == {k: v for k, v in change.items()
                                                 if k != "backend"}
    assert chip_smoke._quality_fusions(path)["fuse_compositing"] is True


# Each quality path's kernels a step (3 epochs of 168 steps) and the f32
# forward of its eval renders: 4 an epoch (two frames, coarse and fine) and
# 2 a held-out view.
QUALITY_A_STEP = {
    "pallas": ({"mlp_fwd": 2, "mlp_bwd": 2}, "mlp_fwd"),
    "pallas_rm": ({"raymarch_fwd": 2, "raymarch_bwd": 2}, "raymarch_fwd"),
    "pallas_f32": ({"mlp_fwd": 2, "mlp_bwd": 2}, "mlp_fwd"),
    "pallas_rm_fused": ({"raymarch_comp_fwd": 2, "raymarch_comp_bwd": 2}, "raymarch_fwd"),
    "pallas_fused": ({"mlp_comp_fwd": 2, "mlp_comp_bwd": 2}, "mlp_fwd"),
    "pallas_fused_loss": ({"mlp_comp_fwd": 1, "mlp_comp_bwd": 1, "mlp_loss_comp": 1}, "mlp_fwd"),
}


@pytest.mark.parametrize("path", list(chip_smoke.QUALITY_PATHS))
def test_quality_launches_are_the_steps_and_the_f32_evals(path):
    steps = QUALITY_STEPS * chip_smoke.QUALITY_EPOCHS
    got = chip_smoke._quality_launches(path, QUALITY_STEPS, QUALITY_HELD)
    if path not in QUALITY_A_STEP:
        assert chip_smoke.QUALITY_PATHS[path][0] == "xla" and got == {}
        return
    a_step, eval_fwd = QUALITY_A_STEP[path]
    want = {k: n * steps for k, n in a_step.items()}
    want[eval_fwd] = want.get(eval_fwd, 0) + 4 * chip_smoke.QUALITY_EPOCHS + 2 * QUALITY_HELD
    assert got == want
    assert set(a_step) == set(chip_smoke.MAIN_PATHS[path])


@pytest.fixture(scope="module")
def quality_first_steps():
    """Each quality path's model config at small widths, one epoch of one
    step through ``train_step.make_epoch_fn`` on the CPU (the kernels' plain
    versions) under ``chip_smoke._first_step_recorded``: its lockstep
    record."""
    torch.manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    n_rays, batch = 96, 48
    tables = (torch.tensor(np.concatenate([rng.normal(size=(n_rays, 3)), np.ones((n_rays, 1))],
                                          -1).astype(np.float32)),
              torch.tensor(np.concatenate([rng.normal(size=(n_rays, 3)),
                                           np.zeros((n_rays, 1))], -1).astype(np.float32)),
              torch.tensor(rng.uniform(size=(n_rays, 3)).astype(np.float32)))
    out = {}
    for path, (backend, dtype, _) in chip_smoke.QUALITY_PATHS.items():
        cfg = tn.NeRFConfig(mlp=tm.MLPConfig(**MLP), compute_dtype=getattr(torch, dtype),
                            backend=backend, n_samples_coarse=N_C, n_samples_fine=N_F,
                            near=2.0, far=6.0, **chip_smoke._quality_fusions(path))
        opt = tts.make_optimizer_with_schedule(LR)
        state = tts.init_train_state(torch.Generator().manual_seed(SEED), cfg, opt,
                                     device="cpu")
        rec = {"init_params": chip_smoke._digest(torch, tree_leaves(state.params))}
        first = {}
        with chip_smoke._first_step_recorded(torch, first):
            tts.make_epoch_fn(cfg, opt, 1, batch)(state, torch.Generator().manual_seed(1),
                                                  *tables)
        out[path] = {**rec, **first}
    return out


@pytest.mark.parametrize("path", list(chip_smoke.QUALITY_PATHS))
def test_quality_paths_first_step_draws_in_lockstep(quality_first_steps, path):
    """Every quality path (the fused ones too) starts from "xla"'s weights and
    takes its first batch and uniforms, and its first step draws from the
    generator exactly what ``nerf.draw_training_uniforms`` draws: the phase's
    lockstep digests, on the CPU."""
    rec = quality_first_steps[path]
    assert rec == quality_first_steps["xla"]
    assert rec["drawn"] == ["fine_u", "strat_u"]
    assert rec["rng_after_step"] == rec["rng_after_draws"]


# The committed JAX-trained weights (flagship widths, 70 epochs of the 256px
# Alexander scene), rendered from radius-4 poses looking at the origin.
H5 = ROOT / "runs" / "256px_alexander_nerf_r04" / "NeRF_model_epoch_070.h5"
FLAGSHIP = dict(hidden_dim=256, last_hidden_dim=128, leaky_relu_alpha=0.05, n_freq_xyz=5,
                n_freq_dir=4, n_angles=2)
GOLDEN_SAMPLES = dict(n_samples_coarse=64, n_samples_fine=128, near=2.0, far=6.0)
GOLDEN_POSES = ((0.4, 0.3), (0.4, 2.0), (0.1, 4.2))  # (elevation, azimuth), radians
GOLDEN_RAYS = 96  # a pose, drawn from a 64x64 frame
# Against JAX, f32. The trained field is peaky (95 % of these rays opaque):
# the merged z are the inverse CDF of the coarse weights, which turns a
# last-place change of a weight into a moved sample, and the fine pass reads
# those samples. JAX against itself from the weights moved by one ulp (five
# draws) reads rgb up to 4.4e-6, depth 9.5e-6 and z 1.03e-5 relative; the
# port, whose every operation may round differently, 9.6e-6, 2.1e-5 and
# 3.2e-5. The tolerances are about five times the port's.
RGB_TOL, DEPTH_TOL, Z_ATOL, Z_RTOL = 5e-5, 1e-4, 1e-5, 1e-4


def _golden_rays():
    rng = np.random.default_rng(SEED)
    orig, dirs = [], []
    for elev, azim in GOLDEN_POSES:
        pos = 4 * np.array([np.cos(elev) * np.sin(azim), np.sin(elev),
                            np.cos(elev) * np.cos(azim)])
        c2w, _, _ = chip_smoke._sphere_view(pos, 1, 0.7)
        o, d = tcam.rays_for_image(64, 64, 0.7, torch.tensor(c2w, dtype=torch.float32))
        pick = torch.as_tensor(rng.choice(64 * 64, GOLDEN_RAYS, replace=False))
        orig.append(o[pick])
        dirs.append(d[pick])
    return torch.cat(orig), torch.cat(dirs)


@pytest.fixture(scope="module")
def golden_jax():
    """The rays, and JAX's deterministic render of them: ``(orig, dirs, rgb,
    depth, z)``."""
    jcfg = jn.NeRFConfig(mlp=jm.MLPConfig(**FLAGSHIP), compute_dtype=jnp.float32,
                         backend="xla", **GOLDEN_SAMPLES)
    orig, dirs = _golden_rays()
    result, z = jn.render(jckpt.load_keras_h5(H5, jcfg.mlp), jcfg, None, orig.numpy(),
                          dirs.numpy())
    return (orig, dirs, np.asarray(result.rgb),
            np.asarray(jrend.depth_from_weights(result.weights, z)), np.asarray(z))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_committed_weights_render_like_jax(golden_jax, backend):
    """The counterpart of tests/test_golden.py on the repository's own
    weights: rgb, expected depth and the merged z of a deterministic f32
    render against the JAX package's."""
    orig, dirs, rgb, depth, z = golden_jax
    tcfg = tn.NeRFConfig(mlp=tm.MLPConfig(**FLAGSHIP), compute_dtype=torch.float32,
                         backend=backend, **GOLDEN_SAMPLES)
    tp = tckpt.load_keras_h5(H5, tcfg.mlp)
    jp = jckpt.load_keras_h5(H5, jm.MLPConfig(**FLAGSHIP))
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp), strict=True):
        assert np.array_equal(a.numpy(), np.asarray(b))
    result, tz = tn.render(tp, tcfg, None, orig, dirs)
    tdepth = (result.weights * tz).sum(-1).numpy()
    print(f"{backend}: rgb {np.abs(result.rgb.numpy() - rgb).max():.3e}, depth "
          f"{np.abs(tdepth - depth).max():.3e}, z relative "
          f"{(np.abs(tz.numpy() - z) / np.abs(z)).max():.3e}")
    np.testing.assert_allclose(tz.numpy(), z, atol=Z_ATOL, rtol=Z_RTOL)
    np.testing.assert_allclose(result.rgb.numpy(), rgb, atol=RGB_TOL, rtol=0)
    np.testing.assert_allclose(tdepth, depth, atol=DEPTH_TOL, rtol=0)
