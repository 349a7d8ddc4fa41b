"""Port vs JAX package: DietNeRF (the ViT embedder, the consistency loss, the
pose sampler, the diet step and the DietTrainer) at tests/test_dietnerf.py's
tiny sizes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from nerf_and_dietnerf_tpu.core import cameras as jcam
from nerf_and_dietnerf_tpu.core import pose_math as jpose
from nerf_and_dietnerf_tpu.data.loaders import Dataset as JDataset
from nerf_and_dietnerf_tpu.models import dietnerf as jdiet
from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.models import nerf as jn
from nerf_and_dietnerf_tpu.models import vit as jvit
from nerf_and_dietnerf_tpu.tasks import runner as jrunner
from nerf_and_dietnerf_tpu.train import diet_trainer as jdt
from nerf_and_dietnerf_tpu.utils import config as jconfig
from nerf_and_dietnerf_tpu_torch import main as tmain
from nerf_and_dietnerf_tpu_torch.core import cameras as tcam
from nerf_and_dietnerf_tpu_torch.core import sampling as tsam
from nerf_and_dietnerf_tpu_torch.data.loaders import Dataset as TDataset
from nerf_and_dietnerf_tpu_torch.models import dietnerf as tdiet
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.models import nerf as tn
from nerf_and_dietnerf_tpu_torch.models import vit as tvit
from nerf_and_dietnerf_tpu_torch.tasks import runner as trunner
from nerf_and_dietnerf_tpu_torch.train import diet_trainer as tdt
from nerf_and_dietnerf_tpu_torch.train import train_step as tts
from nerf_and_dietnerf_tpu_torch.utils import config as tconfig
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

# tests/test_dietnerf.py's TINY_VIT, TINY_NERF and TINY_DIET, in both packages.
VIT = dict(image_size=32, patch_size=16, hidden_dim=32, n_layers=2, n_heads=4, mlp_dim=64)
MLP = dict(hidden_dim=16, last_hidden_dim=8, n_freq_xyz=2, n_freq_dir=2)
NERF = dict(n_samples_coarse=4, n_samples_fine=4, near=0.5, far=3.0)
DIET = dict(interval=3, cs_image_size=16, cs_samples=4, cs_chunk_rays=64)
J_VIT, T_VIT = jvit.ViTConfig(**VIT), tvit.ViTConfig(**VIT)
J_DIET = jdiet.DietConfig(**DIET, vit=J_VIT)
T_DIET = tdiet.DietConfig(**DIET, vit=T_VIT)
FOV = 0.8

# Tolerances. f32 ViT features: the two packages sum in another order, so
# 1e-5 of the largest feature. bf16 ViT: both round the same operands to bf16,
# but a rounding can flip where the f32 sums before it differ in the last
# place; two bf16 ulps (2^-7) normwise.
VIT_RTOL_F32, VIT_NORMWISE_BF16 = 1e-5, 2.0 ** -7
RESIZE_ATOL = 1e-6          # preprocess against jax.image.resize
HF_ATOL = 2e-4              # tests/test_dietnerf.py's tolerance against HF's forward
# The consistency loss in f32 renders, a bf16 ViT: relative on the value,
# normwise per network on the gradients (bf16 flips, as above).
CS_RTOL, CS_GRAD_NORMWISE = 1e-4, 2.0 ** -7
# The checkpointed, chunked render against one unchunked pass with the same
# draws: f32 sums in another order, normwise.
RENDER_GRAD_NORMWISE = 1e-5
# One diet step with Adam: the updated parameters, absolute (the lr is 5e-4,
# and Adam's first step moves each parameter by lr * g / (|g| + eps)).
ADAM_ATOL = 1e-6


def _t(a):
    return torch.tensor(np.asarray(a))


def _normwise(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _nerf_configs(backend="xla"):
    return (jn.NeRFConfig(mlp=jm.MLPConfig(**MLP), compute_dtype=jnp.float32, backend=backend,
                          **NERF),
            tn.NeRFConfig(mlp=tm.MLPConfig(**MLP), compute_dtype=torch.float32,
                          backend=backend, **NERF))


def _nerf_params(jcfg):
    """tests/test_dietnerf.py's parameters: sigma biases raised by 1 so the
    compositing has signal."""
    p = jn.init_params(jax.random.PRNGKey(0), jcfg)
    for which in ("coarse", "fine"):
        p[which]["sigma_out"]["bias"] = p[which]["sigma_out"]["bias"] + 1.0
    return p, tm.params_from_jax(p)


def _vit_params(seed=1):
    p = jvit.init_params(jax.random.PRNGKey(seed), J_VIT)
    return p, tvit.params_from_jax(p)


# --------------------------------------------------------------------------- #
# The ViT                                                                      #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_features_match_jax(dtype):
    jp, tp = _vit_params(0)
    imgs = np.random.default_rng(0).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jvit.extract_features(jp, jnp.asarray(imgs), J_VIT,
                                           compute_dtype=getattr(jnp, dtype)))
    got = tvit.extract_features(tp, _t(imgs), T_VIT, compute_dtype=getattr(torch, dtype))
    assert got.shape == (3, 32) and got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy() / np.abs(ref).max(), ref / np.abs(ref).max(),
                                   atol=VIT_RTOL_F32)
    else:
        assert _normwise(got.numpy(), ref) < VIT_NORMWISE_BF16


@pytest.mark.parametrize("with_config", [False, True], ids=["plain", "geometry"])
def test_vit_npz_written_by_jax_loads(tmp_path, with_config):
    """A file JAX's save_npz wrote loads into the port and gives the features
    of the same parameters carried across; infer_config agrees; and JAX reads
    the port's save_npz back."""
    jp, tp = _vit_params(0)
    path = tmp_path / "jax.npz"
    jvit.save_npz(path, jp, config=J_VIT if with_config else None)
    got = tvit.infer_config(path)
    ref = jvit.infer_config(path)
    assert (got is None) == (ref is None) == (not with_config)
    if with_config:
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    loaded = tvit.load_pretrained(path, T_VIT)
    for a, b in zip(tree_leaves(loaded), tree_leaves(tp)):
        assert torch.equal(a, b)
    imgs = _t(np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    assert torch.equal(tvit.extract_features(loaded, imgs, T_VIT),
                       tvit.extract_features(tp, imgs, T_VIT))
    tvit.save_npz(tmp_path / "port.npz", loaded, config=T_VIT if with_config else None)
    back = jvit.load_pretrained(str(tmp_path / "port.npz"), J_VIT)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jvit.infer_config(tmp_path / "port.npz") == jvit.infer_config(path)


def _hf_model(seed, n_layers, **kw):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.ViTConfig(
        image_size=32, patch_size=16, hidden_size=32, num_hidden_layers=n_layers,
        num_attention_heads=4, intermediate_size=64, **kw)
    torch.manual_seed(seed)
    return transformers.ViTModel(hf_cfg, add_pooling_layer=False).eval()


def test_vit_hf_import_semantic_parity(tmp_path):
    """A tiny HF checkpoint (.safetensors) imported by the port gives HF's
    [CLS] features (every transpose and reshape of the importer), and the
    JAX importer's parameters."""
    save_file = pytest.importorskip("safetensors.torch").save_file
    cfg = dataclasses.replace(T_VIT, ln_eps=1e-6)
    model = _hf_model(0, 2, hidden_act="gelu", layer_norm_eps=cfg.ln_eps,
                      hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    path = tmp_path / "vit.safetensors"
    save_file({k: v.contiguous() for k, v in model.state_dict().items()}, str(path))
    params = tvit.load_pretrained(path, cfg)
    for a, b in zip(tree_leaves(params), jax.tree.leaves(jvit.load_pretrained(str(path),
                                                                              J_VIT))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    imgs = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ours = tvit.extract_features(params, _t(imgs), cfg, compute_dtype=torch.float32)
    with torch.no_grad():
        hf = model(pixel_values=_t(imgs.transpose(0, 3, 1, 2))).last_hidden_state[:, 0]
    np.testing.assert_allclose(ours.numpy(), hf.numpy(), atol=HF_ATOL, rtol=HF_ATOL)


def test_vit_hf_import_torch_bin(tmp_path):
    """The torch-.bin import maps the same state dict (read with
    weights_only=True)."""
    model = _hf_model(1, 1)
    path = tmp_path / "vit.bin"
    torch.save(model.state_dict(), str(path))
    params = tvit.load_pretrained(path, dataclasses.replace(T_VIT, n_layers=1))
    assert params["patch_embed"]["kernel"].shape == (16 * 16 * 3, 32)
    assert len(params["blocks"]) == 1
    ref = model.state_dict()["encoder.layer.0.attention.attention.query.weight"]
    assert torch.equal(params["blocks"][0]["q"]["kernel"], ref.T)


@pytest.mark.parametrize("size_in,size_out", [(16, 32), (150, 224), (256, 224)],
                         ids=["up_16_32", "up_150_224", "down_256_224"])
def test_preprocess_matches_jax(size_in, size_out):
    imgs = np.random.default_rng(size_in).uniform(size=(2, size_in, size_in, 3)).astype(
        np.float32)
    jcfg = jvit.ViTConfig(image_size=size_out)
    tcfg = tvit.ViTConfig(image_size=size_out)
    ref = np.asarray(jvit.preprocess(jnp.asarray(imgs), jcfg))
    got = tvit.preprocess(_t(imgs), tcfg)
    assert got.shape == (2, size_out, size_out, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=RESIZE_ATOL, rtol=0)
    np.testing.assert_allclose(tvit.preprocess(_t(imgs[0]), tcfg).numpy(), ref[:1],
                               atol=RESIZE_ATOL, rtol=0)


# --------------------------------------------------------------------------- #
# Pose sampling and the gate                                                   #
# --------------------------------------------------------------------------- #

def _sphere_poses():
    rng = np.random.default_rng(0)
    return np.stack([jpose.sphere_c2w(2.0, x, y, 0.0) for x, y in rng.uniform(-60, 60, (12, 2))])


@pytest.mark.parametrize("kind", ["spherical", "slerp"])
def test_pose_sampler_draws_jax_poses(kind):
    if kind == "spherical":
        poses, seed = _sphere_poses(), 1
        samplers = [m.PoseSampler.from_dataset(poses, test_img_idx=0, seed=seed)
                    for m in (jdiet, tdiet)]
        assert samplers[0].is_spherical and samplers[1].is_spherical
    else:
        poses = np.stack([np.eye(4)] * 8)
        poses[:, 0, 3] = np.arange(8)
        poses[:, 2, 3] = 0.1 * np.arange(8) ** 2
        samplers = [m.PoseSampler(poses, None, None, seed=2) for m in (jdiet, tdiet)]
    for _ in range(6):
        a, b = (s.sample() for s in samplers)
        np.testing.assert_array_equal(a, b)


def _scene(n=6, size=8, spherical=True):
    """Cameras on a ring around a point (a spherical scene), or on a line."""
    rng = np.random.default_rng(0)
    poses = []
    for i in range(n):
        phi = 2 * np.pi * i / n
        center = np.array([0.2, 0.1, -0.3])
        pos = (np.array([3 * np.sin(phi), 0.5, 3 * np.cos(phi)]) + center if spherical
               else np.array([0.3 * i, 0.0, 2.5]))
        z = (pos - center) / np.linalg.norm(pos - center) if spherical else np.array([0, 0, 1.0])
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, pos
        poses.append(c2w)
    fields = dict(images=rng.uniform(size=(n, size, size, 3)).astype(np.float32),
                  camera_poses=np.asarray(poses, np.float32), field_of_view=FOV, near=0.5,
                  far=3.0, average_c2w_before_recenter=np.eye(4), scale=1.0)
    return JDataset(**fields), TDataset(**fields)


RUN = dict(type_of_model="DietNeRF", allow_random_embedder=True, hidden_layer_dim=16,
           last_hidden_layer_dim=8, n_pos_enc_dim_xyz=2, n_pos_enc_view_dir=2,
           n_render_samples_coarse=4, n_render_samples_fine=4, near_depth_render=0.5,
           far_depth_render=3.0, n_rays_in_batch_train=16, n_rays_in_batch_render=100,
           n_epochs=3, test_img_idx=0, idx_train_img_to_plot=1, compute_dtype="float32",
           backend="pallas")


def _trainers(tmp_path, spherical=True, **changes):
    jds, tds = _scene(spherical=spherical)
    kw = dict(RUN, **changes)
    jt = jdt.DietTrainer(jconfig.RunConfig(**kw), jds, tmp_path / "jax", diet=J_DIET)
    tt = tdt.DietTrainer(tconfig.RunConfig(**kw), tds, tmp_path / "port", device="cpu",
                         diet=T_DIET)
    return jt, tt


def _target_rows(targets, embeddings):
    """Index of each target row among the embeddings, -1 for a zero row."""
    targets, embeddings = np.asarray(targets), np.asarray(embeddings)
    out = []
    for row in targets:
        hits = [j for j, e in enumerate(embeddings) if np.array_equal(row, e)]
        assert len(hits) <= 1
        out.append(hits[0] if hits else -1 if not row.any() else -2)
    return out


@pytest.mark.parametrize("start_epoch", [-1, 1], ids=["fresh", "resumed_at_epoch_1"])
def test_presampled_diet_inputs_and_gate_match_jax(tmp_path, start_epoch):
    """The budget, the diet positions, the novel poses (bitwise) and the
    target picks of two epochs are the JAX DietTrainer's, from a fresh start
    and after a resume at epoch 1 (no weights on disk: the count starts at
    the epoch's step, the budget from the remaining epochs)."""
    jt, tt = _trainers(tmp_path, starting_epoch_number=start_epoch)
    n = tt.data.batches_per_epoch
    assert n == jt.data.batches_per_epoch == 20  # 5 train views x 64 rays / 16
    assert tt.consistency_budget == jt.consistency_budget == tdiet.consistency_steps_budget(
        n, 3, max(start_epoch, 0), T_DIET) == jdiet.consistency_steps_budget(
        n, 3, max(start_epoch, 0), J_DIET)
    assert tt.target_embeddings.shape == jt.target_embeddings.shape == (5, 32)
    diet_steps = 0
    for epoch in range(max(start_epoch, 0), 3):
        jt.state.step = jnp.asarray(epoch * n, jnp.int32)
        tt.state.step = epoch * n
        jc2w, jtarget = (np.asarray(a) for a in jt._presample_diet_inputs())
        tc2w, ttarget = (a.numpy() for a in tt._presample_diet_inputs())
        np.testing.assert_array_equal(tc2w, jc2w)
        rows = _target_rows(ttarget, tt.target_embeddings.numpy())
        assert rows == _target_rows(jtarget, jt.target_embeddings)
        want = [i for i in range(n) if tdiet.is_diet_step(epoch * n + i, T_DIET,
                                                          tt.consistency_budget)]
        assert [i for i, r in enumerate(rows) if r >= 0] == want
        assert [i for i in range(n) if jc2w[i].any()] == want
        diet_steps += len(want)
    assert diet_steps > 4


# --------------------------------------------------------------------------- #
# The consistency loss and the diet step                                       #
# --------------------------------------------------------------------------- #

C2W = np.eye(4, dtype=np.float32)
C2W[2, 3] = 2.0


def _jax_consistency(params, vit_params, cfg, c2w, target):
    """The JAX package's consistency loss with key=None, composed from its
    public pieces in ``models/dietnerf.py:85-137``'s order (its own function
    splits the key it is given)."""
    size, n = J_DIET.cs_image_size, J_DIET.cs_samples
    orig, dirs = jcam.rays_for_image(size, size, FOV, jnp.asarray(c2w))
    chunk = J_DIET.cs_chunk_rays

    @jax.checkpoint
    def render_chunk(o, d):
        return jn.render(params, cfg, None, o, d, n_samples_coarse=n, n_samples_fine=n,
                         diagnostics=False)[0].rgb

    rgb = jnp.concatenate([render_chunk(orig[i:i + chunk], dirs[i:i + chunk])
                           for i in range(0, size * size, chunk)], 0)
    emb = jvit.extract_features(jax.tree.map(jax.lax.stop_gradient, vit_params),
                                jvit.preprocess(rgb.reshape(size, size, 3), J_VIT), J_VIT)[0]
    cos = jnp.sum(emb * target) / (jnp.linalg.norm(emb) * jnp.linalg.norm(target) + 1e-8)
    return J_DIET.weight * (1.0 - cos) / 2.0


def _normwise_per_network(tg, jg):
    return {which: _normwise(np.concatenate([t.numpy().ravel() for t in tree_leaves(tg[which])]),
                             np.concatenate([np.asarray(j).ravel()
                                             for j in jax.tree.leaves(jg[which])]))
            for which in ("coarse", "fine")}


@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas_rm"])
def test_consistency_loss_and_grads_match_jax(backend):
    jcfg, tcfg = _nerf_configs(backend)
    jp, tp = _nerf_params(jcfg)
    jv, tv = _vit_params()
    target = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (32,)))
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: _jax_consistency(p, jv, jcfg, C2W, target)))(jp)
    tloss, _, tg = tts.loss_and_grads(tp, lambda p: (tdiet.consistency_loss(
        p, tv, tcfg, T_DIET, None, C2W, FOV, _t(target))[0], None))
    assert 0.0 <= float(tloss) <= T_DIET.weight
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=CS_RTOL)
    for which, err in _normwise_per_network(tg, jg).items():
        assert err < CS_GRAD_NORMWISE, (which, err)
        assert float(sum(t.abs().sum() for t in tree_leaves(tg[which]))) > 0


def test_one_diet_step_with_adam_matches_jax(monkeypatch):
    """``diet_train_step`` (its ray loss at fixed z: JAX's
    ``training_losses_fixed_z``; the consistency loss with key=None), then
    Adam, against the same step composed in JAX with ``optax.adam``."""
    jcfg, tcfg = _nerf_configs("pallas")
    jp, tp = _nerf_params(jcfg)
    jv, tv = _vit_params()
    rng = np.random.default_rng(3)
    orig = np.concatenate([rng.normal(size=(24, 3)) * 0.2, np.ones((24, 1))], -1)
    dirs = np.concatenate([rng.normal(size=(24, 3)) * 0.3 + [0, 0, -1], np.zeros((24, 1))], -1)
    rgb = rng.uniform(size=(24, 3))
    z_c = np.sort(rng.uniform(0.5, 3.0, (24, 4)), -1)
    z_f = np.sort(rng.uniform(0.5, 3.0, (24, 4)), -1)
    orig, dirs, rgb, z_c, z_f = (a.astype(np.float32) for a in (orig, dirs, rgb, z_c, z_f))
    target = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (32,)))

    def jloss(p):
        ray_data = (jnp.asarray(a) for a in (orig, dirs, rgb, z_c, z_f))
        return (jn.training_losses_fixed_z(p, jcfg, *ray_data)
                + _jax_consistency(p, jv, jcfg, C2W, target))

    opt = optax.adam(5e-4)
    # Eager, op by op: jit's fusions reorder sums, and where a gradient is
    # near Adam's eps the first update lr * g / (|g| + eps) follows its last
    # digits.
    jloss_value, grads = jax.value_and_grad(jloss)(jp)
    updates, _ = opt.update(grads, opt.init(jp), jp)
    jnew = optax.apply_updates(jp, updates)

    def fixed_z_losses(p, cfg, key, o, d, c, draws=None):
        loss = tn.training_losses_fixed_z(p, cfg, o, d, c, _t(z_c), _t(z_f))
        return loss, {"loss": loss.detach()}

    monkeypatch.setattr(tdiet.nerf, "training_losses", fixed_z_losses)
    optimizer = tts.make_optimizer_with_schedule(5e-4)
    state = tts.TrainState(tp, optimizer.init(tp), 0)
    state, metrics = tdiet.diet_train_step(
        state, None, (_t(orig), _t(dirs), _t(rgb)), C2W, _t(target), tv, config=tcfg,
        diet=T_DIET, optimizer=optimizer, field_of_view=FOV)
    assert state.step == 1 and state.opt_state["count"] == 1
    assert set(metrics) == {"loss", "loss_for_rays", "cosine_similarity_loss"}
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss_value), rtol=CS_RTOL)
    for a, b in zip(tree_leaves(state.params), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ADAM_ATOL, rtol=0)


def _render_grads(render, params):
    cot = torch.tensor(np.random.default_rng(4).normal(size=(16, 16, 3)), dtype=torch.float32)
    _, _, grads = tts.loss_and_grads(params, lambda p: ((render(p) * cot).sum(), None))
    return torch.cat([g.reshape(-1) for g in tree_leaves(grads)])


def test_checkpointed_render_keeps_its_draws():
    """The chunked, checkpointed render with a live generator has the
    gradient of one unchunked pass without checkpoint fed the same draws:
    the recompute in the backward must see the forward's z. (A render that
    drew its uniforms inside the checkpointed function would draw new ones
    in the recompute and fail here.)"""
    jcfg, tcfg = _nerf_configs("xla")
    _, tp = _nerf_params(jcfg)
    n, chunk = T_DIET.cs_samples, T_DIET.cs_chunk_rays
    got = _render_grads(lambda p: tdiet.render_image_differentiable(
        p, tcfg, T_DIET, torch.Generator().manual_seed(5), C2W, FOV), tp)

    gen = torch.Generator().manual_seed(5)
    draws = [(torch.rand((chunk, n), generator=gen),
              tsam.sorted_uniforms(gen, (chunk,), n)) for _ in range(4)]
    draws = {"strat_u": torch.cat([d[0] for d in draws]),
             "fine_u": torch.cat([d[1] for d in draws])}

    def whole(p):
        orig, dirs = tcam.rays_for_image(16, 16, FOV, torch.as_tensor(C2W))
        result, _ = tn.render(p, tcfg, None, orig, dirs, n, n, diagnostics=False, draws=draws)
        return result.rgb.reshape(16, 16, 3)

    ref = _render_grads(whole, tp)
    assert _normwise(got.numpy(), ref.numpy()) < RENDER_GRAD_NORMWISE


# --------------------------------------------------------------------------- #
# The DietTrainer, the runner and the CLI                                      #
# --------------------------------------------------------------------------- #

def test_diet_trainer_fits_one_epoch_on_cpu(tmp_path, monkeypatch):
    """One epoch through ``fit``: the target embeddings, a finite loss, the
    epoch's mean metrics under JAX's keys, and a diet step at each position
    the gate picks."""
    _, tds = _scene(spherical=False)
    run = tconfig.RunConfig(**dict(RUN, n_epochs=1))
    trainer = tdt.DietTrainer(run, tds, tmp_path, device="cpu", diet=T_DIET)
    assert trainer.target_embeddings.shape == (5, T_VIT.hidden_dim)
    assert not trainer.pose_sampler.is_spherical
    epoch_metrics, diet_losses = [], []
    make, step = trainer._make_epoch_fn, tdiet.diet_train_step

    def recording_epoch_fn():
        epoch_fn = make()

        def run_epoch(*args):
            state, metrics = epoch_fn(*args)
            epoch_metrics.append(metrics)
            return state, metrics
        return run_epoch

    def recording_step(state, *args, **kw):
        state, metrics = step(state, *args, **kw)
        diet_losses.append((state.step, float(metrics["cosine_similarity_loss"])))
        return state, metrics

    monkeypatch.setattr(trainer, "_make_epoch_fn", recording_epoch_fn)
    monkeypatch.setattr(tdiet, "diet_train_step", recording_step)
    history = trainer.fit(log=None)
    assert len(history) == 1 and np.isfinite(history[0].loss)
    assert trainer.state.step == trainer.data.batches_per_epoch == 20
    (metrics,) = epoch_metrics
    assert set(metrics) == {"loss", "loss_for_rays", "cosine_similarity_loss", "psnr_coarse",
                            "psnr_fine"}
    assert [s for s, _ in diet_losses] == [3, 6, 9, 12, 15, 18]  # budget int(20 * 0.95) = 19
    assert all(0.0 <= v <= T_DIET.weight for _, v in diet_losses)
    np.testing.assert_allclose(float(metrics["cosine_similarity_loss"]),
                               sum(v for _, v in diet_losses) / 20, rtol=1e-6)


def test_random_embedder_requires_explicit_opt_in(tmp_path):
    """A DietNeRF run without ViT weights fails unless the config opts into
    the degraded random embedder, with the JAX package's message."""
    _, tds = _scene()
    run = tconfig.RunConfig(**dict(RUN, allow_random_embedder=False))
    with pytest.raises(ValueError, match="allow_random_embedder") as port_err:
        tdt.DietTrainer(run, tds, tmp_path, device="cpu", diet=T_DIET)
    jds, _ = _scene()
    with pytest.raises(ValueError) as jax_err:
        jdt.DietTrainer(jconfig.RunConfig(**dict(RUN, allow_random_embedder=False)), jds,
                        tmp_path / "jax", diet=J_DIET)
    assert str(port_err.value) == str(jax_err.value)


def test_npz_geometry_replaces_the_diet_vit(tmp_path, capsys):
    """--vit-weights with an npz that embeds its geometry: the trainer adopts
    it, says so, and loads the file's parameters."""
    _, tds = _scene()
    jp, tp = _vit_params(3)
    path = tmp_path / "small.npz"
    jvit.save_npz(path, jp, config=J_VIT)
    run = tconfig.RunConfig(**dict(RUN, allow_random_embedder=False))
    trainer = tdt.DietTrainer(run, tds, tmp_path / "run", device="cpu", vit_weights=str(path))
    assert trainer.diet.vit == T_VIT
    assert "replaces" in capsys.readouterr().out
    for a, b in zip(tree_leaves(trainer.vit_params), tree_leaves(tp)):
        assert torch.equal(a, b)


CLI_CONFIG = {
    "dataset_type": "colmap", "dataset_location": "unused", "general_save_location": "unused",
    "tasks_to_perform": {"start_training": True},
    "neural_net": {"type_of_model": "DietNeRF", "hidden_layer_dim": 16,
                   "last_hidden_layer_dim": 8, "n_pos_enc_dim_xyz": 2, "n_pos_enc_view_dir": 2,
                   "n_rays_in_batch_train": 64, "n_rays_in_batch_render": 100},
    "render": {"n_render_samples_coarse": 4, "n_render_samples_fine": 4,
               "near_depth_render": 0.5, "far_depth_render": 3.0},
    "training": {"n_epochs": 1, "test_img_idx": 0, "idx_train_img_to_plot": 1},
    "mesh": {"compute_dtype": "float32", "allow_random_embedder": True},
}


def _artifacts(save_dir):
    return sorted(str(p.relative_to(save_dir)) for p in save_dir.rglob("*")
                  if p.is_file() and p.relative_to(save_dir).parts[0] not in ("orbax", "states"))


def test_main_trains_dietnerf_on_the_cpu(tmp_path, monkeypatch):
    """``main.main(["--platform", "cpu"])`` on a tiny DietNeRF config with
    ``allow_random_embedder: true`` returns 0 and writes the JAX runner's
    artifact names."""
    jds, tds = _scene()
    monkeypatch.setattr(jrunner.loaders, "load_dataset", lambda *a, **k: jds)
    monkeypatch.setattr(trunner.loaders, "load_dataset", lambda *a, **k: tds)
    cfg = tmp_path / "diet.yaml"
    cfg.write_text(yaml.safe_dump(CLI_CONFIG))
    assert tmain.main([str(cfg), "--save-root", str(tmp_path / "port"), "--platform",
                       "cpu"]) == 0
    jrunner.Runner(cfg, save_root=str(tmp_path / "jax")).start()
    got = _artifacts(tmp_path / "port" / "diet_save_dir_0")
    assert got == _artifacts(tmp_path / "jax" / "diet_save_dir_0")
    assert "saved_weights/NeRF_model_epoch_001.h5" in got

