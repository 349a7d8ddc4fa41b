"""How far the JAX package parts from itself in the lockstep of
``tests/test_torch_quality.py``: the windows that test holds the port to.

    JAX_PLATFORMS=cpu python tests/quality_controls.py [CONTROL ...]

Each control trains JAX's "xla" step at the test's config beside a second
JAX run that differs only in its last places: ``ulpN`` starts from the
initial weights each moved one ulp up or down (numpy seed N); ``rev``,
``roll1``, ``half``, ``pair`` and ``rpN`` feed the batch's rows (and their
uniforms) in another order, so every sum over rows runs in another order.
The second run draws nothing itself: its uniforms are JAX's from the step's
key, its resampling uniforms injected. Prints, a control a line, the largest
relative loss gap by step range and the held-out PSNR gap at each eval
point (about 20 s a control). Default: all fourteen. Two more reports:
``step0`` (the first step's gradients, each leaf's largest difference over
its largest entry: the port against JAX, JAX from one-ulp-moved weights,
JAX's Pallas path in interpret mode, and the first two again with
``stop_fine_z_grad``) and ``golden`` (the committed weights' render of
``test_committed_weights_render_like_jax`` from weights moved by one ulp,
five draws, against the unmoved one).
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

import chip_smoke  # noqa: E402
import test_torch_quality as T  # noqa: E402
from nerf_and_dietnerf_tpu.core import rendering as jrend  # noqa: E402
from nerf_and_dietnerf_tpu.core import sampling as jsam  # noqa: E402
from nerf_and_dietnerf_tpu.data import pipeline as jpipe  # noqa: E402
from nerf_and_dietnerf_tpu.models import mlp as jm  # noqa: E402
from nerf_and_dietnerf_tpu.models import nerf as jn  # noqa: E402
from nerf_and_dietnerf_tpu.train import checkpoint as jckpt  # noqa: E402
from nerf_and_dietnerf_tpu.train import train_step as jts  # noqa: E402
from nerf_and_dietnerf_tpu_torch.models import mlp as tm  # noqa: E402
from nerf_and_dietnerf_tpu_torch.models import nerf as tn  # noqa: E402
from nerf_and_dietnerf_tpu_torch.train import train_step as tts  # noqa: E402
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves  # noqa: E402

CONTROLS = ["ulp1", "ulp2", "ulp3", "ulp4", "ulp5", "ulp6", "ulp7",
            "rev", "roll1", "half", "pair", "rp1", "rp2", "rp3"]
RANGES = ((0, 1), (1, 3), (3, 30), (30, T.STEPS))


def reorder(name, x):
    x = np.asarray(x)
    if name == "rev":
        return x[::-1]
    if name == "roll1":
        return np.roll(x, 1, 0)
    if name == "half":
        return np.roll(x, x.shape[0] // 2, 0)
    if name == "pair":
        return x.reshape(-1, 2, *x.shape[1:])[:, ::-1].reshape(x.shape)
    if name.startswith("rp"):
        return x[np.random.default_rng(int(name[2:])).permutation(x.shape[0])]
    return x


def moved_one_ulp(params, seed):
    """Every weight moved one ulp up or down (numpy ``seed``)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(np.nextafter(
        np.asarray(x), np.where(rng.random(np.shape(x)) < 0.5, np.inf, -np.inf)
        .astype(np.float32))), params)


def leaf_errors(got, ref):
    """(coarse, fine): the largest over each network's leaves of the largest
    difference over the leaf's largest entry."""
    errs = [float(np.abs(np.asarray(a) - np.asarray(b)).max()
                  / max(1e-30, float(np.abs(np.asarray(b)).max())))
            for a, b in zip(got, ref, strict=True)]
    half = len(errs) // 2
    return max(errs[:half]), max(errs[half:])


def step0():
    ds = chip_smoke.quality_scene(T.VIEWS, T.SIZE)
    held = chip_smoke.quality_held_out(T.VIEWS)
    train = [i for i in range(T.VIEWS) if i not in held]
    table = jpipe.build_ray_table(ds.images[train], ds.camera_poses[train], ds.field_of_view)
    idx = np.random.default_rng(T.SEED).permutation(table[0].shape[0])[:T.RAYS]
    batch = tuple(t[idx] for t in table)
    key = jax.random.fold_in(jax.random.PRNGKey(T.SEED + 1), 0)
    k_strat, k_res, _, _ = jax.random.split(key, 4)
    draws = {"strat_u": torch.tensor(np.asarray(jax.random.uniform(k_strat, (T.RAYS, T.N_C)))),
             "fine_u": torch.tensor(np.asarray(jsam.sorted_uniforms(k_res, (T.RAYS,), T.N_F)))}
    common = dict(n_samples_coarse=T.N_C, n_samples_fine=T.N_F, near=ds.near, far=ds.far)
    for stop in (False, True):
        cfg = jn.NeRFConfig(mlp=jm.MLPConfig(**T.MLP), compute_dtype=jnp.float32,
                            backend="xla", stop_fine_z_grad=stop, **common)
        tcfg = tn.NeRFConfig(mlp=tm.MLPConfig(**T.MLP), compute_dtype=torch.float32,
                             backend="xla", stop_fine_z_grad=stop, **common)
        params = jn.init_params(jax.random.PRNGKey(T.SEED), cfg)

        def grads(p, c=cfg):
            return jax.tree.leaves(jax.grad(
                lambda q: jn.training_losses(q, c, key, *batch)[0])(p))

        ref = grads(params)
        _, _, tg = tts.loss_and_grads(tm.params_from_jax(params), lambda p: tn.training_losses(
            p, tcfg, None, *(torch.tensor(b) for b in batch), draws=draws))
        rows = {"port": leaf_errors(tree_leaves(tg), ref),
                "JAX, weights moved one ulp": leaf_errors(grads(moved_one_ulp(params, 5)), ref)}
        if not stop:
            rows["JAX pallas (interpret)"] = leaf_errors(
                grads(params, dataclasses.replace(cfg, backend="pallas")), ref)
        for k, (c, f) in rows.items():
            print(f"step 0, stop_fine_z_grad={stop}, {k} against JAX: coarse {c:.2e}, "
                  f"fine {f:.2e}", flush=True)


def golden():
    cfg = jn.NeRFConfig(mlp=jm.MLPConfig(**T.FLAGSHIP), compute_dtype=jnp.float32,
                        backend="xla", **T.GOLDEN_SAMPLES)
    orig, dirs = (t.numpy() for t in T._golden_rays())
    params = jckpt.load_keras_h5(T.H5, cfg.mlp)

    def render(p):
        result, z = jn.render(p, cfg, None, orig, dirs)
        return (np.asarray(result.rgb), np.asarray(jrend.depth_from_weights(result.weights, z)),
                np.asarray(z))

    rgb, depth, z = render(params)
    for seed in range(1, 6):
        r, d, zz = render(moved_one_ulp(params, seed))
        print(f"golden, weights moved one ulp (seed {seed}): rgb {np.abs(r - rgb).max():.2e}, "
              f"depth {np.abs(d - depth).max():.2e}, z relative "
              f"{(np.abs(zz - z) / np.abs(z)).max():.2e}", flush=True)


def run(name):
    ds = chip_smoke.quality_scene(T.VIEWS, T.SIZE)
    held = chip_smoke.quality_held_out(T.VIEWS)
    train = [i for i in range(T.VIEWS) if i not in held]
    table = jpipe.build_ray_table(ds.images[train], ds.camera_poses[train], ds.field_of_view)
    cfg = jn.NeRFConfig(mlp=jm.MLPConfig(**T.MLP), compute_dtype=jnp.float32, backend="xla",
                        n_samples_coarse=T.N_C, n_samples_fine=T.N_F, near=ds.near, far=ds.far)
    opt = jts.make_optimizer_with_schedule(T.LR)
    state = jts.init_train_state(jax.random.PRNGKey(T.SEED), cfg, opt)
    other = state
    if name.startswith("ulp"):
        moved = moved_one_ulp(state.params, int(name[3:]))
        other = jts.TrainState(moved, opt.init(moved), state.step)
    step = jax.jit(functools.partial(jts.train_step, config=cfg, optimizer=opt))
    render = jax.jit(lambda p, c2w: jn.render_image(
        p, cfg, None, c2w, ds.field_of_view, T.SIZE, T.SIZE, chunk_size=T.SIZE * T.SIZE,
        diagnostics=False)[0].rgb)

    @jax.jit
    def draws(key):
        k_strat, k_res, _, _ = jax.random.split(key, 4)
        return (jax.random.uniform(k_strat, (T.RAYS, T.N_C)),
                jsam.sorted_uniforms(k_res, (T.RAYS,), T.N_F))

    @jax.jit
    def injected_step(state, batch, strat_u, fine_u):
        """JAX's train step with the step's uniforms given."""
        orig, dirs, target = batch

        def loss_fn(p):
            z = (jnp.linspace(ds.near, ds.far, T.N_C)
                 + strat_u * ((ds.far - ds.near) / T.N_C))
            rgb, weights = jn.render_rays_train(p["coarse"], cfg, orig, dirs, z)
            drawn = jsam.sorted_uniforms
            jsam.sorted_uniforms = lambda key, shape, n: fine_u
            try:
                z_fine = jsam.resample_z_from_weights(None, weights, z, T.N_F)
            finally:
                jsam.sorted_uniforms = drawn
            return (jnp.mean(jnp.square(target - rgb))
                    + jn._fine_mse(p["fine"], cfg, orig, dirs, z_fine, target))

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        return jts.TrainState(optax.apply_updates(state.params, updates), opt_state,
                              state.step + 1), loss

    def held_out(params):
        return T._psnr([float(jnp.mean(jnp.square(render(params, ds.camera_poses[i])
                                                  - ds.images[i]))) for i in held])

    losses, psnr_gaps = [], []
    rng = np.random.default_rng(T.SEED)
    n_batches = table[0].shape[0] // T.RAYS
    for i in range(T.STEPS + 1):
        if i % T.EVAL_EVERY == 0:
            psnr_gaps.append(held_out(other.params) - held_out(state.params))
        if i == T.STEPS:
            break
        if i % n_batches == 0:
            perm = rng.permutation(table[0].shape[0])
        idx = perm[(i % n_batches) * T.RAYS:(i % n_batches + 1) * T.RAYS]
        key = jax.random.fold_in(jax.random.PRNGKey(T.SEED + 1), i)
        state, metrics = step(state, key, tuple(t[idx] for t in table))
        strat_u, fine_u = draws(key)
        ridx = reorder(name, idx)
        other, loss = injected_step(other, tuple(t[ridx] for t in table),
                                    reorder(name, strat_u), reorder(name, fine_u))
        losses.append((float(metrics["loss"]), float(loss)))
    ref, got = np.array(losses).T
    rel = np.abs(got - ref) / ref
    print(f"{name:6s} loss rel gap, steps " + ", ".join(
        f"{a}-{b - 1}: {rel[a:b].max():.2e}" for a, b in RANGES)
        + "; held-out PSNR gap (dB) at steps "
        + ", ".join(f"{s}: {g:+.3f}" for s, g in zip(range(0, T.STEPS + 1, T.EVAL_EVERY),
                                                     psnr_gaps)), flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for name in sys.argv[1:] or CONTROLS:
        {"step0": step0, "golden": golden}.get(name, lambda n=name: run(n))()
