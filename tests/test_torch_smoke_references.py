"""References of ``chip_smoke.py``'s card checks, on the CPU.

The held diet step's reference resamples from the held run's CDFs
(``_cdf_recorded`` / ``_cdf_replayed``): recording changes no value, a
replayed run draws the recorded run's z exactly (so its bin picks and merge
order) while its gradient is its own, and the plain render's coarse gradient
then sits closer to the f64 chain's than against the chain on its own
resampling; pooling the draws' distances is the normwise distance of the
stacked gradients (``_pooled``), and the held diet step runs its draws at
small widths. The distributed check reads each step's loss
(``_step_losses``) without changing the epoch, and holds two ranks' reduced
gradient against one process's from the one-process run's state at each of
the first ``DIST_HELD_STEPS`` steps (``_dist_grads``, two gloo CPU ranks at
small widths)."""

import contextlib
from unittest import mock

import pytest
import torch

import chip_smoke
import torch_parallel_ranks
from nerf_and_dietnerf_tpu_torch.models import mlp
from nerf_and_dietnerf_tpu_torch.models import nerf
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib
from nerf_and_dietnerf_tpu_torch.tools.chain import normwise
from nerf_and_dietnerf_tpu_torch.train import train_step as ts
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves, tree_map

N_RAYS = 64


def _setup():
    config = nerf.NeRFConfig(mlp=mlp.MLPConfig(hidden_dim=32, last_hidden_dim=16),
                             n_samples_coarse=16, n_samples_fine=16, backend="pallas",
                             compute_dtype=torch.float32)
    params = nerf.init_params(torch.Generator().manual_seed(0), config)
    gen = torch.Generator().manual_seed(1)
    o = torch.randn((N_RAYS, 3), generator=gen)
    o = 4 * o / o.norm(dim=1, keepdim=True)
    d = -o / 4 + 0.3 * torch.randn((N_RAYS, 3), generator=gen)
    return config, params, o, d


def _render(params, config, o, d, patches=()):
    """rgb, fine z and the coarse network's gradient of sum(rgb)."""
    with contextlib.ExitStack() as stack:
        for owner, name, value in patches:
            stack.enter_context(mock.patch.object(owner, name, value))
        out = {}

        def loss(p):
            result, z = nerf.render(p, config, torch.Generator().manual_seed(2), o, d,
                                    diagnostics=False)
            out["rgb"], out["z"] = result.rgb.detach(), z.detach()
            return result.rgb.sum(), None

        _, _, grads = ts.loss_and_grads(params, loss)
    out["coarse"] = torch.cat([g.reshape(-1) for g in tree_leaves(grads["coarse"])])
    return out


def test_recording_changes_nothing_and_replay_draws_the_recorded_z():
    config, params, o, d = _setup()
    plain = _render(params, config, o, d)
    record = []
    recorded = _render(params, config, o, d, chip_smoke._cdf_recorded(record))
    assert len(record) == 1 and record[0].shape == (N_RAYS, config.n_samples_coarse)
    for k in plain:
        assert torch.equal(plain[k], recorded[k])
    # Another network resampling from the recorded CDFs: the recorded z, its
    # own gradient through its own CDF.
    moved = tree_map(lambda t: t * 1.01, params)
    own_run = _render(moved, config, o, d)
    own = []
    replayed = _render(moved, config, o, d, chip_smoke._cdf_replayed(record, own))
    assert torch.equal(replayed["z"], plain["z"]) and not torch.equal(own_run["z"], plain["z"])
    assert len(own) == 1 and not torch.equal(own[0], record[0])
    assert torch.isfinite(replayed["coarse"]).all() and replayed["coarse"].abs().max() > 0
    # Replaying a run's own CDFs gives that run back.
    again = _render(moved, config, o, d, chip_smoke._cdf_replayed(own, []))
    for k in again:
        assert torch.equal(again[k], own_run[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_the_f64_chain_on_the_runs_cdfs_removes_the_resamplings_amplification(seed):
    """The plain f32 render (the kernels' wrappers on the CPU) against the
    f64 chain: the coarse gradient's distance with the chain resampling from
    the run's CDFs is below its distance to the chain resampling from its
    own, and the run's CDFs lie within TOL of the chain's."""
    config, params, o, d = _setup()
    params = tree_map(lambda t: t * (1 + 0.1 * seed), params)
    record, own = [], []
    run = _render(params, config, o, d, chip_smoke._cdf_recorded(record))
    f64 = chip_smoke._plain_twins(torch, torch.float64)
    chain = _render(params, config, o, d, f64 + chip_smoke._cdf_replayed(record, own))
    free = _render(params, config, o, d, f64)
    on_runs = normwise(run["coarse"], chain["coarse"].double())
    on_own = normwise(run["coarse"], free["coarse"].double())
    assert normwise(record[0], own[0].double()) <= chip_smoke.TOL["float32"]
    assert on_runs < on_own, (on_runs, on_own)


def test_plain_twin_backward_refuses_a_work_other_than_its_own():
    """``_plain_twins``' backward runs in the twin's ``work``: given that work,
    none, or a ``branches=`` mask by keyword it gives the plain version's
    result in that work; asked for another work it raises."""
    cfg = mlp.MLPConfig(hidden_dim=32, last_hidden_dim=16)
    ws, bs = rc.flatten_params(mlp.init_params(torch.Generator().manual_seed(0), cfg), cfg,
                               torch.float32)
    gen = torch.Generator().manual_seed(1)
    x, d = torch.randn((40, cfg.xyz_dim), generator=gen), torch.randn((40, cfg.dir_dim),
                                                                       generator=gen)
    g = torch.randn((40, 4), generator=gen)
    twin = dict((name, value) for owner, name, value in
                chip_smoke._plain_twins(torch, torch.float64) if owner is rc)["mlp_bwd_plain"]
    want = rc.mlp_bwd_plain(ws, bs, cfg, x, d, g, torch.float32, torch.float64)
    mask = rc.own_branches(ws, bs, cfg, x, d, torch.float32, torch.float64)
    for got in (twin(ws, bs, cfg, x, d, g, torch.float32),
                twin(ws, bs, cfg, x, d, g, torch.float32, torch.float64),
                twin(ws, bs, cfg, x, d, g, torch.float32, branches=mask)):
        for a, b in zip(tree_leaves(list(got)), tree_leaves(list(want))):
            assert a.dtype == torch.float32 and torch.equal(a, b.float())
    with pytest.raises(ValueError, match="asked for"):
        twin(ws, bs, cfg, x, d, g, torch.float32, torch.float32)


def test_step_losses_record_every_steps_loss_and_change_nothing():
    config, params, o, d = _setup()
    opt = ts.make_optimizer_with_schedule(5e-4)
    rgb = torch.rand((N_RAYS, 3), generator=torch.Generator().manual_seed(3))
    epoch = ts.make_epoch_fn(config, opt, 4, N_RAYS // 4)
    state = ts.TrainState(params=params, opt_state=opt.init(params), step=0)
    plain_state, plain = epoch(state, torch.Generator().manual_seed(4), o, d, rgb)
    record = []
    with mock.patch.object(*chip_smoke._step_losses(record)):
        got_state, got = epoch(state, torch.Generator().manual_seed(4), o, d, rgb)
    assert len(record) == 4 and all(v.shape == () for v in record)
    assert float(got["loss"]) == float(plain["loss"]) == pytest.approx(
        float(torch.stack(record).mean()))
    for a, b in zip(tree_leaves(got_state.params), tree_leaves(plain_state.params)):
        assert torch.equal(a, b)


def test_pooled_distance_is_the_stacked_gradients_normwise_distance():
    gen = torch.Generator().manual_seed(5)
    draws = [{w: (torch.randn(50, generator=gen, dtype=torch.float64),
                  torch.randn(50, generator=gen, dtype=torch.float64) * (k + 1))
              for w in ("coarse", "fine")} for k in range(3)]
    squares = [{w: (float((g - c).square().sum()), float(c.square().sum()))
                for w, (g, c) in d.items()} for d in draws]
    pooled = chip_smoke._pooled(squares)
    for w in ("coarse", "fine"):
        g = torch.cat([d[w][0] for d in draws])
        c = torch.cat([d[w][1] for d in draws])
        assert pooled[w] == pytest.approx(normwise(g, c), rel=1e-12)
    # One draw alone: its own normwise distance.
    one = chip_smoke._pooled(squares[:1])
    assert one["fine"] == pytest.approx(normwise(*draws[0]["fine"]), rel=1e-12)


def test_held_diet_step_pools_the_f32_vits_draws(monkeypatch, tmp_path):
    """``_diet_held_step`` end to end at small widths on the CPU, where the
    kernels' wrappers take their plain versions: one draw with the bf16 ViT,
    ``DIET_DRAWS`` with the f32 ViT, every ratio 1."""
    import dataclasses

    from nerf_and_dietnerf_tpu_torch.models import dietnerf, vit
    from nerf_and_dietnerf_tpu_torch.train.diet_trainer import DietTrainer

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    run = dataclasses.replace(chip_smoke._diet_run("pallas"), allow_random_embedder=True,
                              **SMALL_RUN)
    diet = dietnerf.DietConfig(cs_image_size=12, cs_samples=8, cs_chunk_rays=64,
                               vit=vit.ViTConfig(image_size=32, patch_size=16, hidden_dim=32,
                                                 n_layers=2, n_heads=2, mlp_dim=64))
    trainer = DietTrainer(run, chip_smoke.synthetic_scene(**SMALL_SCENE), tmp_path,
                          device="cpu", diet=diet)
    c2w = torch.as_tensor(trainer.pose_sampler.sample(), dtype=torch.float32)
    out = chip_smoke._diet_held_step(torch, trainer, c2w, trainer.target_embeddings[0], "small")
    for nerf_type in ("float32", "bfloat16"):
        for vit_type, n in (("bfloat16", 1), ("float32", chip_smoke.DIET_DRAWS)):
            held = out[f"nerf_{nerf_type}_vit_{vit_type}"]
            assert [r["draw"] for r in held["draws"]] == list(range(chip_smoke.SEED,
                                                                    chip_smoke.SEED + n))
            assert "vs_f64_own_resampling" in held["draws"][0]
            assert all("vs_f64_own_resampling" not in r for r in held["draws"][1:])
            assert held["pooled"]["kernel"] == held["pooled"]["plain"]
            assert all(0 < v < chip_smoke.TOL_DIET_GRAD for v in held["pooled"]["plain"].values())
    assert out["checkpoint_vs_none"]["bitwise"]


# chip_smoke._dist_grads cut down: 32 / 16 wide, 64 rays a batch of two
# 24x24 training views (18 batches), 8 + 8 samples.
SMALL_RUN = {"hidden_layer_dim": 32, "last_hidden_layer_dim": 16, "n_rays_in_batch_train": 64,
             "n_render_samples_coarse": 8, "n_render_samples_fine": 8}
SMALL_SCENE = {"n_views": 3, "size": 24}


@pytest.fixture(scope="module")
def dist_grads(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_grads") / "grads.pt"
    mesh_lib.spawn(torch_parallel_ranks.smoke_dist_grads, ["cpu", "cpu"],
                   args=(str(out), SMALL_RUN, SMALL_SCENE), timeout=120.0)
    return torch.load(out, weights_only=False)


def test_dist_grads_one_process_side_is_the_single_device_epoch(dist_grads):
    """Each step's one-process gradient is, bitwise, the one the plain epoch
    hands Adam at that step: the teacher-forced run follows ``run_epoch``'s
    permutation, batches and key."""
    steps = chip_smoke.DIST_HELD_STEPS
    assert len(dist_grads["one"]) == len(dist_grads["epoch"]) == steps
    for got, want in zip(dist_grads["one"], dist_grads["epoch"]):
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def test_dist_grads_hold_two_ranks_at_every_step_and_the_control_does_not(dist_grads):
    steps = chip_smoke.DIST_HELD_STEPS
    assert len(dist_grads["sound"]) == len(dist_grads["local"]) == steps
    sound = [chip_smoke._normwise_leaves(torch, g, r)
             for g, r in zip(dist_grads["sound"], dist_grads["one"])]
    local = [chip_smoke._normwise_leaves(torch, g, r)
             for g, r in zip(dist_grads["local"], dist_grads["one"])]
    assert max(sound) <= chip_smoke.TOL_DIST_GRAD, sound
    assert min(local) > chip_smoke.TOL_DIST_GRAD, local
    # The steps differ: each is taken from the state the run has reached.
    assert not torch.equal(dist_grads["one"][0][0], dist_grads["one"][-1][0])
