"""Port vs JAX package: data parallelism (``parallel/mesh.py``,
``parallel/render_tiles.py``, the per-rank ray slices and the step's draws).

JAX runs on a 2-device sub-mesh of its tests' 8 virtual CPU devices; the port
runs 2 spawned gloo ranks on the CPU (``tests/torch_parallel_ranks.py``), all
of its cases in one spawn. Tolerances: renders 1e-5 (rgb, weights and z, as
the port's single-device render is held to JAX's), the sharded objective's loss 1e-5 relative and
every gradient leaf 1e-5 of its largest entry (f32: the sums over rows differ
in grouping only), the port's own sharded frame bitwise its single-device
frame (each ray is computed alone, so the tiling cannot change its bits).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_and_dietnerf_tpu.data import pipeline as jpipeline
from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.models import nerf as jn
from nerf_and_dietnerf_tpu.parallel import mesh as jmesh
from nerf_and_dietnerf_tpu.parallel import render_tiles as jtiles
from nerf_and_dietnerf_tpu_torch.data import pipeline as tpipeline
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.models import nerf as tn
from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib
from nerf_and_dietnerf_tpu_torch.parallel import render_tiles
from nerf_and_dietnerf_tpu_torch.parallel.mesh import DataGroup
from nerf_and_dietnerf_tpu_torch.train import train_step as ts
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

import torch_parallel_ranks

# tests/test_parallel_render.py's TINY.
MLP = dict(hidden_dim=16, last_hidden_dim=8, n_freq_xyz=2, n_freq_dir=2)
TINY = dict(n_samples_coarse=4, n_samples_fine=4, near=0.5, far=3.0)
RENDER_TOL = 1e-5  # rgb, weights and z (tests/test_torch_nerf.py's render tolerance)
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5
FOV = 0.8
C2W = np.eye(4, dtype=np.float32)
C2W[2, 3] = 2.0
SPAWN_TIMEOUT = 120.0

# The sharded objective: 32 rays (16 a rank), 8 + 12 fixed samples.
N_RAYS, N_C, N_F = 32, 8, 12
OBJ_MLP = dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=3, n_freq_dir=2, n_angles=2)
GRAD_CASES = {
    "xla": dict(backend="xla"),
    "pallas": dict(backend="pallas"),
    "pallas_rm": dict(backend="pallas_rm"),
    # fuse_fine_loss too: on a group both packages take the split fine pass.
    "pallas_fused": dict(backend="pallas", fuse_compositing=True, fuse_fine_loss=True),
    "pallas_rm_fused": dict(backend="pallas_rm", fuse_compositing=True),
}
RENDER_BACKENDS = ("xla", "pallas", "pallas_rm")


def _configs(mlp, common, **kw):
    return (jn.NeRFConfig(mlp=jm.MLPConfig(**mlp), compute_dtype=jnp.float32, **common, **kw),
            tn.NeRFConfig(mlp=tm.MLPConfig(**mlp), compute_dtype=torch.float32, **common, **kw))


def _jax_params(jcfg, seed=0):
    p = jn.init_params(jax.random.PRNGKey(seed), jcfg)
    return p, tm.params_from_jax(p)


def _objective_inputs():
    rng = np.random.default_rng(0)
    orig = np.concatenate([rng.normal(size=(N_RAYS, 3)) * 0.2, np.ones((N_RAYS, 1))], -1)
    dirs = np.concatenate([rng.normal(size=(N_RAYS, 3)) * 0.3 + [0, 0, 1],
                           np.zeros((N_RAYS, 1))], -1)
    rgb = rng.uniform(size=(N_RAYS, 3))
    z_c = np.sort(rng.uniform(2, 6, (N_RAYS, N_C)), -1)
    z_f = np.sort(rng.uniform(2, 6, (N_RAYS, N_F)), -1)
    return [a.astype(np.float32) for a in (orig, dirs, rgb, z_c, z_f)]


def _render_cases():
    """name -> (the rank side's inputs, JAX's config and params)."""
    cases = {}
    for backend in RENDER_BACKENDS:
        jcfg, tcfg = _configs(MLP, TINY, backend=backend)
        jp, tp = _jax_params(jcfg)
        common = dict(params=tp, config=tcfg, c2w=C2W, fov=FOV, diagnostics=False)
        # vs JAX: deterministic, 81 rays: the chunk rounds up to 82 (one pad ray).
        cases[f"jax_{backend}"] = (dict(common, seed=None, h=9, w=9, chunk=16384,
                                        via_frame=False), jcfg, jp)
        # vs the port's single-device frame: a live generator, 256 rays in
        # two chunks of 128 (a multiple of the world size).
        cases[f"live_{backend}"] = (dict(common, seed=1, h=16, w=16, chunk=128,
                                         via_frame=False), jcfg, jp)
    jcfg, tcfg = _configs(MLP, TINY)
    jp, tp = _jax_params(jcfg)
    common = dict(params=tp, config=tcfg, c2w=C2W, fov=FOV, h=8, w=8, chunk=16384)
    cases["diagnostics"] = (dict(common, seed=2, diagnostics=True, via_frame=False), jcfg, jp)
    cases["frame"] = (dict(common, seed=None, diagnostics=False, via_frame=True), jcfg, jp)
    return cases


def _grad_cases():
    inputs = _objective_inputs()
    cases = {}
    for name, kw in GRAD_CASES.items():
        jcfg, tcfg = _configs(OBJ_MLP, dict(n_samples_coarse=N_C, n_samples_fine=N_F,
                                            near=2.0, far=6.0), **kw)
        jp, tp = _jax_params(jcfg)
        tensors = dict(zip(("orig", "dirs", "rgb", "z_c", "z_f"), map(torch.tensor, inputs)))
        cases[name] = (dict(params=tp, config=tcfg, **tensors), jcfg, jp)
    return cases, inputs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case's rank-side result from one spawn of 2 gloo CPU ranks."""
    tmp = tmp_path_factory.mktemp("ranks")
    renders, (grads, inputs) = _render_cases(), _grad_cases()
    torch.save({"renders": {k: v[0] for k, v in renders.items()},
                "grads": {k: v[0] for k, v in grads.items()}}, tmp / "in.pt")
    mesh_lib.spawn(torch_parallel_ranks.renders_and_grads, ["cpu", "cpu"],
                   args=(str(tmp / "in.pt"), str(tmp / "out.pt")), timeout=SPAWN_TIMEOUT)
    return torch.load(tmp / "out.pt", weights_only=False), renders, grads, inputs


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("backend", RENDER_BACKENDS)
def test_sharded_render_matches_jax_sharded_render(two_ranks, backend):
    """Deterministic mode with a padded ray count: the port's two-rank frame
    against the JAX package's on a 2-device mesh (Pallas in interpret mode)."""
    out, cases, _, _ = two_ranks
    c, jcfg, jp = cases[f"jax_{backend}"]
    jres, jz = jtiles.render_image_sharded(
        jp, jcfg, jmesh.make_mesh(jax.devices()[:2]), None, jnp.asarray(c["c2w"]), c["fov"],
        c["h"], c["w"], chunk_size=c["chunk"], diagnostics=False)
    got = out["renders"][f"jax_{backend}"]
    _close(got["rgb"], jres.rgb, RENDER_TOL)
    _close(got["weights"], jres.weights, RENDER_TOL)
    _close(got["z"], jz, RENDER_TOL)


@pytest.mark.parametrize("backend", RENDER_BACKENDS)
def test_sharded_render_pixel_equal_to_single_device(two_ranks, backend):
    """Same generator, chunk size a multiple of the world size: the same
    chunks and draws on both paths, so the frames are equal bitwise."""
    out, cases, _, _ = two_ranks
    c = cases[f"live_{backend}"][0]
    single, z = tn.render_image(c["params"], c["config"], torch.Generator().manual_seed(c["seed"]),
                                c["c2w"], c["fov"], c["h"], c["w"], chunk_size=c["chunk"],
                                diagnostics=False, device="cpu")
    got = out["renders"][f"live_{backend}"]
    for name, ref in (("rgb", single.rgb), ("weights", single.weights), ("z", z)):
        torch.testing.assert_close(got[name], ref, rtol=0, atol=0)


def test_sharded_render_diagnostics(two_ranks):
    """diagnostics=True gives the whole RenderResult (the ray-value plot task
    renders through it on group runs), equal to the single-device one."""
    out, cases, _, _ = two_ranks
    c = cases["diagnostics"][0]
    single, z = tn.render_image(c["params"], c["config"], torch.Generator().manual_seed(c["seed"]),
                                c["c2w"], c["fov"], c["h"], c["w"], diagnostics=True,
                                device="cpu")
    got = out["renders"]["diagnostics"]
    n_total = TINY["n_samples_coarse"] + TINY["n_samples_fine"]
    assert got["sample_rgb"].shape == (c["h"], c["w"], n_total, 3)
    assert got["alpha"].shape == got["cumprod"].shape == got["z"].shape == (c["h"], c["w"],
                                                                             n_total)
    for name in ("rgb", "weights", "cumprod", "alpha", "sample_rgb"):
        torch.testing.assert_close(got[name], getattr(single, name), rtol=0, atol=0)
    torch.testing.assert_close(got["z"], z, rtol=0, atol=0)


def test_render_frame_routes_by_mesh(two_ranks, monkeypatch):
    """render_frame is the one routing point: a group => tile-sharded,
    None => nerf.render_image; the frames agree (deterministic mode)."""
    out, cases, _, _ = two_ranks
    c = cases["frame"][0]
    calls = []
    monkeypatch.setattr(render_tiles, "render_image_sharded",
                        lambda *a, **k: calls.append(a) or (None, None))
    one, z = render_tiles.render_frame(c["params"], c["config"], None, None, c["c2w"], c["fov"],
                                       c["h"], c["w"], diagnostics=False, device="cpu")
    assert not calls
    render_tiles.render_frame(c["params"], c["config"], DataGroup(0, 2, torch.device("cpu")),
                              None, c["c2w"], c["fov"], c["h"], c["w"], diagnostics=False)
    assert len(calls) == 1
    got = out["renders"]["frame"]
    _close(got["rgb"], one.rgb, RENDER_TOL)
    _close(got["z"], z, RENDER_TOL)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_sharded_objective_and_grads_match_jax(two_ranks, name):
    """Each rank's fixed-z loss on its rows, then the step's gradient
    all-reduce, against ``jax.value_and_grad`` of the JAX objective with
    ``config.mesh`` set (its shard_mapped kernels and psums); then one Adam
    update from the reduced gradient against ``optax.adam``'s from it."""
    out, _, cases, inputs = two_ranks
    _, jcfg, jp = cases[name]
    jcfg = dataclasses.replace(jcfg, mesh=jmesh.make_mesh(jax.devices()[:2]))
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, *x: jn.training_losses_fixed_z(p, jcfg, *x)))(jp, *map(jnp.asarray, inputs))
    got = out["grads"][name]
    np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=LOSS_RTOL)
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(got["grads"])
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        b = np.asarray(b)
        scale = max(1e-8, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=0, atol=GRAD_TOL)
    # Adam from the reduced gradient: optax.adam fed the same gradient.
    reduced = jax.tree.unflatten(jax.tree.structure(jg), [t.numpy() for t in tleaves])
    opt = optax.adam(5e-3)
    updates, _ = opt.update(reduced, opt.init(jp), jp)
    for a, b in zip(tree_leaves(got["params"]), jax.tree.leaves(optax.apply_updates(jp, updates))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def _ray_scene(n=3, h=6, w=6):
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * n)
    poses[:, 2, 3] = 2.0 + 0.2 * np.arange(n)
    poses[:, 0, 3] = 0.1 * np.arange(n)
    return images, poses


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_slices_match_jax_ray_dataset(rank):
    """Fed the permutation ``jax.random.permutation`` gives, a rank's rows
    of every batch are the JAX ``RayDataset``'s for that process, bitwise."""
    images, poses = _ray_scene()
    key = jax.random.PRNGKey(5)
    jds = jpipeline.RayDataset(images, poses, FOV, 20, process_index=rank, process_count=2)
    tds = tpipeline.RayDataset(images, poses, FOV, 20, process_index=rank, process_count=2)
    assert tds.per_host == jds.per_host == 10
    assert tds.batches_per_epoch == jds.batches_per_epoch == 5
    perm = torch.tensor(np.asarray(jax.random.permutation(key, jds.n_rays)))
    for b, (jo, jd, jrgb) in enumerate(jds.epoch(key)):
        idx = tds.batch_indices(perm, b).numpy()
        np.testing.assert_array_equal(tds.rgb[idx], jrgb)
        np.testing.assert_allclose(tds.origins[idx], jo, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tds.directions[idx], jd, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rank", [0, 1])
def test_epoch_loop_takes_the_rank_slice(rank):
    """``train_step.run_epoch`` gives a rank's step the dataset's
    ``batch_indices`` rows (held against JAX's above) of its permutation,
    and the two ranks' rows make up the single-device batch, in order."""
    images, poses = _ray_scene()
    tds = tpipeline.RayDataset(images, poses, FOV, 20, process_index=rank, process_count=2)
    table = (torch.arange(tds.n_rays),)

    def batches(mesh):
        seen = []

        def step(state, batch, i):
            seen.append(batch[0])
            return state, {"loss": torch.zeros(())}

        ts.run_epoch(None, torch.Generator().manual_seed(5), table, tds.batches_per_epoch,
                     tds.batch_size, step, mesh)
        return seen

    perm = torch.randperm(tds.n_rays, generator=torch.Generator().manual_seed(5))
    ours = batches(DataGroup(rank, 2, torch.device("cpu")))
    others = batches(DataGroup(1 - rank, 2, torch.device("cpu")))
    wholes = batches(None)
    assert len(ours) == len(wholes) == tds.batches_per_epoch
    for b, (mine, other, whole) in enumerate(zip(ours, others, wholes)):
        assert torch.equal(mine, tds.batch_indices(perm, b))
        assert torch.equal(torch.cat([mine, other] if rank == 0 else [other, mine]), whole)


def test_uneven_batch_split_raises_like_jax():
    images, poses = _ray_scene()
    for make in (jpipeline.RayDataset, tpipeline.RayDataset):
        with pytest.raises(ValueError, match="batch_size must divide evenly across hosts"):
            make(images, poses, FOV, 21, process_index=0, process_count=2)
    with pytest.raises(ValueError, match="batch_size must divide evenly across hosts"):
        mesh_lib.batch_rows(21, 0, 2)


def _batch(n=24, seed=4):
    rng = np.random.default_rng(seed)
    orig = np.concatenate([rng.normal(size=(n, 3)) * 0.2, np.ones((n, 1))], -1)
    dirs = np.concatenate([rng.normal(size=(n, 3)) * 0.3 + [0, 0, 1], np.zeros((n, 1))], -1)
    return tuple(torch.tensor(a, dtype=torch.float32)
                 for a in (orig, dirs, rng.uniform(size=(n, 3))))


@pytest.mark.parametrize("noise", [0.0, 0.5], ids=["no_noise", "density_noise"])
def test_predrawn_draws_give_the_inline_step_bitwise(noise):
    """``nerf.draw_training_uniforms`` draws what ``training_losses`` draws
    inline, in its order: a step fed them equals the inline-drawn step
    bitwise (parameters, Adam state, metrics)."""
    _, tcfg = _configs(OBJ_MLP, dict(n_samples_coarse=N_C, n_samples_fine=N_F, near=2.0,
                                      far=6.0), backend="xla", sigma_noise_std=noise)
    opt = ts.Adam()
    state = ts.init_train_state(torch.Generator().manual_seed(0), tcfg, opt)
    batch = _batch()
    inline, m1 = ts.train_step(state, torch.Generator().manual_seed(9), batch, config=tcfg,
                               optimizer=opt)
    key = torch.Generator().manual_seed(9)
    draws = tn.draw_training_uniforms(key, tcfg, batch[0].shape[0], True)
    fed, m2 = ts.train_step(state, key, batch, config=tcfg, optimizer=opt, draws=draws)
    for a, b in zip(tree_leaves(inline.params) + tree_leaves(inline.opt_state["nu"]),
                    tree_leaves(fed.params) + tree_leaves(fed.opt_state["nu"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert m1.keys() == m2.keys() == {"loss", "psnr_coarse", "psnr_fine"}
    for k in m1:
        torch.testing.assert_close(m1[k], m2[k], rtol=0, atol=0)


def test_rank_draws_reassemble_the_single_device_draws():
    """Each rank draws at the global batch's shape and keeps its rows: the
    two ranks' rows put together are the single-device draws, and each
    rank's generator ends where the single-device one does."""
    _, tcfg = _configs(OBJ_MLP, dict(n_samples_coarse=N_C, n_samples_fine=N_F, near=2.0,
                                      far=6.0), sigma_noise_std=0.5)
    single_key = torch.Generator().manual_seed(3)
    single = tn.draw_training_uniforms(single_key, tcfg, 24, True)
    assert list(single) == ["strat_u", "noise_coarse", "fine_u", "noise_fine"]
    parts, keys = [], []
    for rank in (0, 1):
        key = torch.Generator().manual_seed(3)
        parts.append(ts.group_draws(key, tcfg, DataGroup(rank, 2, torch.device("cpu")), 12,
                                    True, "cpu"))
        keys.append(key)
    for k, v in single.items():
        torch.testing.assert_close(torch.cat([parts[0][k], parts[1][k]]), v, rtol=0, atol=0)
    after = torch.rand(4, generator=single_key)
    for key in keys:
        torch.testing.assert_close(torch.rand(4, generator=key), after, rtol=0, atol=0)
