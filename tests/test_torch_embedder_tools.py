"""Port vs JAX package: the DietNeRF embedder tools
(``tools/train_scene_embedder.py`` and ``tools/eval_embedder_consistency.py``
of both) at tiny widths on the CPU.

The JAX trainer's augmentation and loss are closures inside its ``main()``;
this file restates them from JAX library calls, citing their lines, and feeds
both packages the same draws."""

import importlib.util
import json
import sys
from pathlib import Path

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_and_dietnerf_tpu.models import vit as jvit
from nerf_and_dietnerf_tpu_torch.models import vit as tvit
from nerf_and_dietnerf_tpu_torch.tools import eval_embedder_consistency as tev
from nerf_and_dietnerf_tpu_torch.tools import train_scene_embedder as ttr
from nerf_and_dietnerf_tpu_torch.train.train_step import apply_updates, loss_and_grads
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parent.parent
VIT = dict(image_size=32, patch_size=16, hidden_dim=32, n_layers=2, n_heads=4, mlp_dim=64)
J_VIT, T_VIT = jvit.ViTConfig(**VIT), tvit.ViTConfig(**VIT)
TEMP = 0.2
PAIRS = 3

# The augmentation: the same f32 products in another order, 1e-5 absolute on
# outputs in [-1, 1].
AUG_ATOL = 1e-5
# Loss and gradients: in f32, 1e-4 of each leaf's largest entry (the loss 1e-5
# relative); in bf16 a rounding of the ViT's operands can flip where the f32
# values before it differ in the last place, so 2e-2 of each leaf's largest.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
# The keys' bias gradients, zero in exact arithmetic, against the tree's
# largest gradient entry.
ZERO_LEAF = 1e-6
ADAM_RTOL = 1e-6          # three cosine-Adam updates against optax's
FEAT_RTOL = 1e-5          # f32 ViT features, scaled by the largest
EVAL_ATOL = 1e-5          # the evaluator's three cosines
CORPUS_ATOL = 1e-6        # load_corpus's resize (an upscale) against jax.image.resize


def _t(a):
    return torch.tensor(np.asarray(a))


# --------------------------------------------------------------------------- #
# The JAX trainer's closures, restated                                          #
# --------------------------------------------------------------------------- #

def jax_augment(img, crop, y0, x0, flip, brightness, contrast, size_out):
    """``tools/train_scene_embedder.py:154-174`` with its draws given (``crop``
    is ``scale`` there; ``y0`` / ``x0`` its offsets in pixels)."""
    size_in = img.shape[0]
    win = crop * size_in
    s = size_out / win
    out = jax.image.scale_and_translate(
        img, (size_out, size_out, 3), (0, 1),
        jnp.array([s, s]), jnp.array([-y0 * s, -x0 * s]),
        method="bilinear",
    )
    out = jnp.where(flip, out[:, ::-1], out)
    out = out * brightness
    mean = out.mean(axis=(0, 1), keepdims=True)
    out = jnp.clip((out - mean) * contrast + mean, 0.0, 1.0)
    return out * 2.0 - 1.0


def jax_embed(p, imgs, dtype):
    """``:176-181``, the ViT's compute type a parameter (bf16 there)."""
    feats = jvit.extract_features(p["vit"], imgs, J_VIT, compute_dtype=dtype)
    h = jax.nn.relu(feats @ p["proj"]["h"]["kernel"] + p["proj"]["h"]["bias"])
    z = h @ p["proj"]["out"]["kernel"] + p["proj"]["out"]["bias"]
    return z / (jnp.linalg.norm(z, axis=-1, keepdims=True) + 1e-8)


def jax_loss(p, v1, v2, dtype, batch):
    """``:189-213`` after the augmentation (``:202-203``)."""
    z = jax_embed(p, jnp.concatenate([v1, v2], axis=0), dtype)
    sim = (z @ z.T) / TEMP
    n = 2 * batch
    sim = sim - 1e9 * jnp.eye(n)
    pos = jnp.concatenate([jnp.arange(batch) + batch, jnp.arange(batch)])
    logp = jax.nn.log_softmax(sim, axis=-1)
    loss = -logp[jnp.arange(n), pos].mean()
    acc = (sim.argmax(axis=-1) == pos).mean()
    return loss, acc


def jax_partners(idx, offs, scene_ids, positives):
    """``:120-128`` and ``:192-200`` with the draws given."""
    n_scenes = int(scene_ids.max()) + 1
    starts = np.asarray([int(np.searchsorted(scene_ids, s)) for s in range(n_scenes)])
    counts = np.asarray([int((scene_ids == s).sum()) for s in range(n_scenes)])
    if positives != "view":
        return idx
    s = scene_ids[idx]
    return starts[s] + offs % counts[s]


def _draws(seed, n, size_in, crops):
    rng = np.random.default_rng(seed)
    crop = np.asarray(crops, np.float32)
    room = size_in - crop * size_in
    return {"crop": crop, "y0": (rng.uniform(size=n) * room).astype(np.float32),
            "x0": (rng.uniform(size=n) * room).astype(np.float32),
            "flip": rng.uniform(size=n) < 0.5,
            "brightness": rng.uniform(0.6, 1.4, n).astype(np.float32),
            "contrast": rng.uniform(0.6, 1.4, n).astype(np.float32)}


def _augment_both(images, d, size_out):
    want = np.stack([np.asarray(jax_augment(jnp.asarray(images[i]), *(d[k][i] for k in (
        "crop", "y0", "x0", "flip", "brightness", "contrast")), size_out))
        for i in range(len(images))])
    got = ttr.augment_with(_t(images), **{k: _t(v) for k, v in d.items()}, size_out=size_out)
    return want, got.numpy()


# --------------------------------------------------------------------------- #
# Augmentation                                                                 #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("size_in,size_out", [(96, 56), (256, 224)])
def test_augment_matches_jax_scale_and_translate(size_in, size_out):
    """Crops that grow (window under the output size) and shrink (over it,
    where JAX's antialiasing widens the triangle), both flips."""
    crops = [0.4, 0.45, 0.8, 0.95, 1.0, 1.0]
    images = np.random.default_rng(0).uniform(size=(len(crops), size_in, size_in, 3)).astype(
        np.float32)
    d = _draws(1, len(crops), size_in, crops)
    d["flip"] = np.asarray([False, True] * 3)
    win = np.asarray(crops) * size_in
    assert (win < size_out).any() and (win > size_out).any()
    want, got = _augment_both(images, d, size_out)
    np.testing.assert_allclose(got, want, atol=AUG_ATOL)
    assert got.shape == (len(crops), size_out, size_out, 3)


def test_augment_draws_follow_the_jax_tools_ranges():
    d = ttr.draw_augment(torch.Generator().manual_seed(0), 4096, 256, "cpu")
    assert 0.4 <= float(d["crop"].min()) and float(d["crop"].max()) <= 1.0
    assert float(d["y0"].min()) >= 0 and float(d["x0"].min()) >= 0
    assert float((d["y0"] + d["crop"] * 256).max()) <= 256
    assert float((d["x0"] + d["crop"] * 256).max()) <= 256
    for k in ("brightness", "contrast"):
        assert 0.6 <= float(d[k].min()) and float(d[k].max()) <= 1.4
    assert 0.45 < float(d["flip"].float().mean()) < 0.55
    out = ttr.augment(torch.Generator().manual_seed(1), torch.rand(2, 64, 64, 3), 32)
    assert out.shape == (2, 32, 32, 3) and -1 <= float(out.min()) and float(out.max()) <= 1


# --------------------------------------------------------------------------- #
# Loss and gradients                                                           #
# --------------------------------------------------------------------------- #

def _params():
    k_init, k1, k2 = jax.random.split(jax.random.PRNGKey(3), 3)
    h = VIT["hidden_dim"]

    def dense_init(k, d_in, d_out):  # tools/train_scene_embedder.py:137-142
        return {"kernel": jax.random.normal(k, (d_in, d_out), jnp.float32) * (d_in ** -0.5),
                "bias": jnp.zeros((d_out,), jnp.float32)}

    jp = {"vit": jvit.init_params(k_init, J_VIT),
          "proj": {"h": dense_init(k1, h, h), "out": dense_init(k2, h, ttr.PROJ_DIM)}}
    return jp, tvit.params_from_jax(jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("positives", ["augment", "view"])
def test_loss_accuracy_and_gradients_match_jax(positives, dtype):
    rng = np.random.default_rng(4)
    scene_ids = np.repeat(np.arange(3), [3, 2, 4])
    corpus = rng.uniform(size=(len(scene_ids), 48, 48, 3)).astype(np.float32)
    idx = rng.integers(0, len(scene_ids), PAIRS)
    offs = rng.integers(0, ttr.VIEW_OFFSETS, PAIRS)
    want_idx2 = jax_partners(idx, offs, scene_ids, positives)
    tids = _t(scene_ids)
    idx2 = ttr.partner_indices(_t(idx), _t(offs), tids, ttr.scene_ranges(tids), positives)
    np.testing.assert_array_equal(idx2.numpy(), want_idx2)
    if positives == "view":
        assert (scene_ids[want_idx2] == scene_ids[idx]).all()
    d1 = _draws(5, PAIRS, 48, [0.5, 0.7, 1.0])
    d2 = _draws(6, PAIRS, 48, [0.9, 0.6, 0.8])
    jv1, tv1 = _augment_both(corpus[idx], d1, VIT["image_size"])
    jv2, tv2 = _augment_both(corpus[want_idx2], d2, VIT["image_size"])

    jp, tp = _params()
    (jl, jacc), jg = jax.value_and_grad(jax_loss, has_aux=True)(
        jp, jnp.asarray(jv1), jnp.asarray(jv2), getattr(jnp, dtype), PAIRS)
    tl, tacc, tg = loss_and_grads(tp, lambda p: ttr.loss_fn(
        p, _t(tv1), _t(tv2), T_VIT, TEMP, getattr(torch, dtype)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL[dtype])
    assert float(tacc) == pytest.approx(float(jacc))
    names = [n for n, _ in tvit._named_leaves(tg)]
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves) == len(names) == 4 + 4 + 2 + 2 * 16
    largest = max(float(np.abs(np.asarray(b)).max()) for b in jleaves)
    for name, a, b in zip(names, tleaves, jleaves):
        b = np.asarray(b)
        if name.endswith(".k.bias"):
            # Zero in exact arithmetic (the softmax is blind to a shift of a
            # query's logits): both sides are summation noise.
            assert np.abs(b).max() < ZERO_LEAF * largest
            assert float(a.abs().max()) < ZERO_LEAF * largest
            continue
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=GRAD_TOL[dtype],
                                   err_msg=name)


def test_nt_xent_masks_self_and_counts_positives():
    z = torch.nn.functional.normalize(torch.randn(8, 16, generator=torch.Generator().manual_seed(0)),
                                      dim=-1)
    loss, acc = ttr.nt_xent(torch.cat([z[:4], z[:4]]), TEMP)
    assert float(acc) == 1.0  # each view's twin is its most similar row
    assert 0 < float(loss) < float(ttr.nt_xent(torch.cat([z[:4], z[4:]]), TEMP)[0])


def test_cosine_adam_matches_optax():
    lr, steps = 3e-3, 2  # the third update runs past the decay's end
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": [rng.standard_normal(4).astype(np.float32)]}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
             for _ in range(3)]
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.1))
    jp, js = params, opt.init(params)
    topt = ttr.CosineAdam(learning_rate=lr, steps=steps)
    tp = tree_map(torch.tensor, params)
    ts = topt.init(tp)
    for g in grads:
        upd, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, ts = topt.update(tree_map(torch.tensor, g), ts)
        tp = apply_updates(tp, tupd)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=ADAM_RTOL)
    assert topt.lr(0) == lr and topt.lr(steps) == pytest.approx(0.1 * lr)
    assert topt.lr(steps + 5) == topt.lr(steps)


# --------------------------------------------------------------------------- #
# The npz, the evaluator and the two tools' main()                             #
# --------------------------------------------------------------------------- #

def _trained_npz(tmp_path):
    jp, tp = _params()
    path = tmp_path / "vit.npz"
    tvit.save_npz(path, tp["vit"], config=T_VIT)
    return path, tp["vit"]


def test_port_npz_loads_in_jax_with_its_geometry(tmp_path):
    path, tparams = _trained_npz(tmp_path)
    jcfg = jvit.infer_config(str(path))
    assert jcfg == J_VIT and tvit.infer_config(path) == T_VIT
    imgs = np.random.default_rng(7).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jvit.extract_features(jvit.load_pretrained(str(path), jcfg),
                                            jnp.asarray(imgs), jcfg, compute_dtype=jnp.float32))
    got = tvit.extract_features(tvit.load_pretrained(path, T_VIT), _t(imgs), T_VIT,
                                compute_dtype=torch.float32).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=FEAT_RTOL)
    # The port reads its own file back bitwise.
    for a, b in zip(tree_leaves(tvit.load_pretrained(path, T_VIT)), tree_leaves(tparams)):
        assert torch.equal(a, b)


def _jax_consistency(feats, scene_ids):
    """``tools/eval_embedder_consistency.py:58-71``'s numbers, unrounded."""
    z = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    sim = z @ z.T
    same = scene_ids[:, None] == scene_ids[None, :]
    off_diag = ~np.eye(len(z), dtype=bool)
    within = float(sim[same & off_diag].mean())
    across = float(sim[~same].mean())
    return {"within_scene_cos": within, "across_scene_cos": across,
            "separation": within - across}


def test_evaluator_matches_a_numpy_restatement_on_jax_features(tmp_path):
    path, _ = _trained_npz(tmp_path)
    rng = np.random.default_rng(8)
    scene_ids = np.repeat(np.arange(3), 4)
    corpus = rng.uniform(size=(len(scene_ids), 16, 16, 3)).astype(np.float32)
    corpus[scene_ids == 1] *= 0.3
    jp = jvit.load_pretrained(str(path), J_VIT)
    feats = np.asarray(jvit.extract_features(jp, jvit.preprocess(jnp.asarray(corpus), J_VIT),
                                             J_VIT, compute_dtype=jnp.float32))
    want = _jax_consistency(feats, scene_ids)
    tp = tvit.load_pretrained(path, T_VIT)
    got = tev.consistency(tev.features(tp, T_VIT, _t(corpus), "cpu"), _t(scene_ids))
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= EVAL_ATOL, (k, got[k], want[k])
    line = json.loads(tev.report(str(path), got))
    assert list(line) == ["embedder", "within_scene_cos", "across_scene_cos", "separation"]


def _write_scenes(root: Path, n_scenes=2, views=3, size=20):
    """PNG views: each scene a coloured disc on its own background."""
    rng = np.random.default_rng(9)
    dirs = []
    yy, xx = np.mgrid[:size, :size]
    for s in range(n_scenes):
        d = root / f"scene{s}"
        d.mkdir()
        colour, back = rng.uniform(size=3), rng.uniform(size=3) * 0.3
        for v in range(views):
            cy, cx = rng.uniform(0.3, 0.7, 2) * size
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < (size / 4) ** 2
            img = np.where(disc[..., None], colour, back)
            imageio.imwrite(d / f"view_{v:02d}.png", (img * 255).astype(np.uint8))
        dirs.append(str(d))
    return dirs


def jax_tool(name):
    """The JAX package's ``tools/<name>.py`` as a module."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                      ROOT / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(ROOT / "tools"))
    return mod


def test_load_corpus_matches_jax_tool(tmp_path):
    dirs = _write_scenes(tmp_path)
    want_imgs, want_ids = jax_tool("train_scene_embedder").load_corpus(dirs, 32)
    got_imgs, got_ids = ttr.load_corpus(dirs, 32)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_allclose(got_imgs.numpy(), want_imgs, atol=CORPUS_ATOL)
    assert got_imgs.dtype == torch.float32 and got_imgs.shape == (6, 32, 32, 3)


@pytest.mark.parametrize("positives", ["augment", "view"])
def test_trainer_and_evaluator_main_on_the_cpu(tmp_path, capsys, positives):
    """Both tools' ``main`` on a tiny corpus of PNG scenes (``--scenes``): the
    trainer writes an npz both packages read with its geometry, the evaluator
    reads it and prints the JAX tool's line."""
    dirs = _write_scenes(tmp_path)
    out = tmp_path / "scene_vit.npz"
    rc = ttr.main(["--device", "cpu", "--out", str(out), "--scenes", *dirs, "--corpus-size",
                   "32", "--steps", "3", "--batch", "4", "--hidden", "32", "--layers", "1",
                   "--heads", "2", "--mlp-dim", "64", "--log-every", "2",
                   "--positives", positives])
    assert rc == 0
    text = capsys.readouterr().out
    assert "corpus: 6 images @ 32px, 2 scenes" in text and "step 2/3: loss=" in text
    assert "step 3/3: loss=" in text
    cfg = ttr.vit_config(32, 1, 2, 64)
    assert tvit.infer_config(out) == cfg
    assert jvit.infer_config(str(out)) == jvit.ViTConfig(**vars(cfg))
    rc = tev.main(["--device", "cpu", "--weights", str(out), "--scenes", *dirs,
                   "--corpus-size", "32"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["embedder"] == str(out)
    assert line["separation"] == pytest.approx(
        line["within_scene_cos"] - line["across_scene_cos"], abs=2e-4)
    assert all(-1 <= line[k] <= 1 for k in ("within_scene_cos", "across_scene_cos"))


def test_train_returns_finite_losses_and_a_falling_loss():
    """A short run of the training loop, ``augment`` pairing, on eight
    distinct noise images: every loss finite, the last five steps' mean
    below the first five's."""
    rng = np.random.default_rng(10)
    images = [rng.uniform(size=(32, 32, 3)).astype(np.float32) * rng.uniform(0.2, 1, 3)
              for _ in range(8)]
    corpus, ids = ttr.corpus_from_arrays(images, [0] * 4 + [1] * 4, 32)
    cfg = ttr.vit_config(32, 1, 2, 64)
    run = ttr.train(corpus, ids, cfg, steps=20, batch=8, lr=1e-3, temp=TEMP,
                    positives="augment", seed=0, device="cpu", log=lambda s: None)
    losses = run["losses"]
    assert len(losses) == 20 and len(run["accs"]) == 20 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_tools_need_a_gpu_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dirs = _write_scenes(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.main(["--out", str(tmp_path / "v.npz"), "--scenes", *dirs])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tev.main(["--scenes", *dirs])
