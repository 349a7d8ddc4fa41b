"""Port vs JAX package: the gradient parity tool (``tools/parity_gpu.py``
against the JAX package's ``tools/parity_tpu.py``) at tiny sizes on the CPU,
where the kernel wrappers run their plain versions."""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_and_dietnerf_tpu.core import sampling as jsam
from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.models import nerf as jn
from nerf_and_dietnerf_tpu_torch.core import sampling as tsam
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.tools import parity_gpu
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
SHAPE = dict(rays=64, coarse=8, fine=16, hidden=32)
# max_rel_err: the same f32 sums in both packages, so to the last place.
MAX_REL_TOL = 1e-7
# A bin may differ only where the uniform lies this close to a CDF value (the
# two packages' CDFs differ in the last place).
BIN_TIE = 1e-6
# The tool's oracle against JAX's fixed-z objective in f32: summation order
# only (tests/test_torch_nerf.py's tolerances), gradients scaled by each
# leaf's largest entry.
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def jax_tool(name):
    """The JAX package's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def problem():
    return parity_gpu.make_problem(1, device="cpu", **SHAPE)


def _jax_config(problem):
    mlp = problem.config.mlp
    return jn.NeRFConfig(mlp=jm.MLPConfig(hidden_dim=mlp.hidden_dim,
                                          last_hidden_dim=mlp.last_hidden_dim),
                         n_samples_coarse=SHAPE["coarse"], n_samples_fine=SHAPE["fine"],
                         compute_dtype=jnp.float32, backend="xla")


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_max_rel_err_matches_jax_tool(seed):
    rng = np.random.default_rng(seed)
    shapes = [(33, 16), (16,), (1,), (4, 4, 3)]

    def tree(scale):
        leaves = [rng.standard_normal(s).astype(np.float32) * scale for s in shapes]
        leaves[2] *= 1e-8  # a leaf under the 1e-6 floor of the scale
        return {"coarse": {"a": leaves[0], "b": [leaves[1], leaves[2]]}, "fine": leaves[3]}

    ref, got = tree(1.0), tree(1.0)
    got = jax.tree.map(lambda r, g: r + 1e-3 * g, ref, got)
    want = jax_tool("parity_tpu").max_rel_err(ref, got)
    t = jax.tree.map(lambda a: torch.tensor(a), ref), jax.tree.map(lambda a: torch.tensor(a), got)
    assert want > 0
    assert abs(parity_gpu.max_rel_err(*t) - want) <= MAX_REL_TOL * want


def test_bins_match_jax_searchsorted(problem):
    """The tool's bins of the coarse weights (the port's CDF bisected with
    ``searchsorted``) against JAX's comparison count on JAX's CDF of the same
    weights and JAX's sorted uniforms, passed through ``u=``."""
    p = problem
    with torch.no_grad():
        from nerf_and_dietnerf_tpu_torch.models import nerf as tn

        _, w = tn.render_rays_train(p.params["coarse"], p.config, p.orig, p.dirs, p.z_coarse)
    u = jsam.sorted_uniforms(jax.random.PRNGKey(21), (SHAPE["rays"],), SHAPE["fine"])
    jw = jnp.asarray(_np(w))
    jcdf = jnp.cumsum(jw / (jnp.sum(jw, axis=-1, keepdims=True) + jsam.CDF_EPS), axis=-1)
    want = np.asarray(jsam._batched_searchsorted(jcdf, u))
    tu = torch.tensor(np.asarray(u))
    got = parity_gpu.coarse_bins(p.params, p.config, p.orig, p.dirs, p.z_coarse, tu).numpy()
    near_tie = np.min(np.abs(np.asarray(u)[..., :, None] - np.asarray(jcdf)[..., None, :]),
                      axis=-1) < BIN_TIE
    differ = got != want
    assert not (differ & ~near_tie).any()
    print(f"bins differing at a near tie: {int(differ.sum())} of {differ.size}")
    assert parity_gpu.bin_agreement(p.config, p.config, p.params, p.orig, p.dirs, p.z_coarse,
                                    SHAPE["fine"], u=tu) == 1.0
    # The resampling itself bisects with the same function.
    cdf = tsam.resampling_cdf(w)
    torch.testing.assert_close(tsam.resampling_bins(cdf, tu), torch.tensor(got))


def _assert_grads_close(got, want):
    jl, tl = jax.tree.leaves(want), tree_leaves(got)
    assert len(jl) == len(tl) == 44
    for a, b in zip(tl, jl):
        b = np.asarray(b)
        scale = max(1e-8, float(np.abs(b).max()))
        np.testing.assert_allclose(_np(a) / scale, b / scale, atol=GRAD_TOL)


def test_plain_run_and_oracle_match_jax_fixed_z_objective(problem):
    """The tool's inputs, its plain f32 run and its recurrence oracle (the
    f64 chain) against JAX's ``training_losses_fixed_z`` in f32 on the same
    arrays and weights."""
    p = problem
    jcfg = _jax_config(p)
    jp = tm.params_to_jax(p.params)
    arrays = [jnp.asarray(_np(t)) for t in (p.orig, p.dirs, p.rgb, p.z_coarse, p.z_fine)]
    jloss, jgrads = jax.value_and_grad(
        lambda q: jn.training_losses_fixed_z(q, jcfg, *arrays))(jp)
    loss, grads = parity_gpu.loss_and_grads(p, p.config)
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    _assert_grads_close(grads, jgrads)
    loss64, grads64 = parity_gpu.oracle_loss_and_grads(p, "recurrence")
    np.testing.assert_allclose(loss64, float(jloss), rtol=LOSS_RTOL)
    _assert_grads_close(grads64, jgrads)
    # The fine z came from the oracle's coarse weights: inside the coarse range, sorted.
    z_f = _np(p.z_fine)
    assert np.all(np.diff(z_f, axis=-1) >= 0)
    z_c = _np(p.z_coarse)
    assert np.all(z_f >= z_c.min(axis=-1, keepdims=True))
    assert np.all(z_f <= z_c.max(axis=-1, keepdims=True))


def test_direct_sin_oracle_is_the_raymarch_paths_function(problem):
    """The direct-sin oracle against the port's "pallas_rm" run on the CPU
    (the plain versions of B6, in f32) and the recurrence oracle against the
    "xla" run: each oracle is its family's function, to f32 sums."""
    p = problem
    for family, backend in (("direct_sin", "pallas_rm"), ("recurrence", "xla")):
        assert parity_gpu.family_of(backend) == family
        loss64, grads64 = parity_gpu.oracle_loss_and_grads(p, family)
        loss, grads = parity_gpu.loss_and_grads(p, dataclasses.replace(p.config, backend=backend))
        np.testing.assert_allclose(loss, loss64, rtol=LOSS_RTOL)
        assert parity_gpu.max_rel_err(grads64, grads) < GRAD_TOL, family
    # The two functions differ: the encodings' sines are rounded differently.
    assert parity_gpu.oracle_loss_and_grads(p, "direct_sin")[0] != \
        parity_gpu.oracle_loss_and_grads(p, "recurrence")[0]


def test_leaky_flips_counts_every_pre_activation(problem):
    flips = parity_gpu.leaky_flips(problem)
    hidden, rays = SHAPE["hidden"], SHAPE["rays"]
    per_row = 8 * hidden + hidden // 2  # the trunk and the view branch's hidden layer
    for net, samples in (("coarse", SHAPE["coarse"]), ("fine", SHAPE["fine"])):
        assert flips[net]["pre_activations"] == rays * samples * per_row
        assert 0 <= flips[net]["flips"] <= flips[net]["pre_activations"]


def test_exact_f32_restores_the_callers_setting():
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    try:
        flags.allow_tf32 = True
        with parity_gpu.exact_f32():
            assert flags.allow_tf32 is False
        assert flags.allow_tf32 is True
    finally:
        flags.allow_tf32 = before


def test_main_writes_the_jax_tools_keys(tmp_path, capsys):
    out = tmp_path / "PARITY_GPU.json"
    rc = parity_gpu.main(["--device", "cpu", "--rays", "64", "--coarse", "8", "--fine", "16",
                          "--hidden", "32", "--out", str(out)])
    res = json.loads(out.read_text())
    assert rc == 0 and res["all_pass"] is True
    assert {"methodology", "shape", "device", "results", "all_pass",
            "bin_agreement_xla_vs_pallas", "bin_agreement_xla_vs_pallas_rm"} <= set(res)
    assert res["device"] == "cpu" and res["shape"] == SHAPE
    runs = [f"{name}/{dtype}" for dtype in ("float32", "bfloat16")
            for name, _ in parity_gpu.PATHS]
    exact = [f"{name}/float32/exact" for name, _ in parity_gpu.PATHS]
    assert len(runs) == 12 and sorted(res["results"]) == sorted(runs + exact)
    jax_keys = {"loss_xla", "loss_kernel", "rel_loss_err", "max_rel_grad_err_vs_xla_same_dtype",
                "max_rel_grad_err_vs_f32_oracle", "xla_same_dtype_err_vs_f32_oracle",
                "criterion", "pass"}
    for k in runs:
        assert jax_keys <= set(res["results"][k]), k
        assert res["results"][k]["launches"] == {}  # the CPU runs the plain versions
    for k in exact:
        assert {"rel_loss_err", "max_rel_grad_err", "criterion", "pass"} <= set(res["results"][k])
    assert set(res["oracle"]) == {"recurrence", "direct_sin"}
    assert set(res["plain"]) == {"float32", "bfloat16"}
    assert res["plain"]["float32"]["max_rel_grad_err_vs_f64_oracle"] < GRAD_TOL
    assert set(res["leaky_flips_f32_vs_f64"]) == {"coarse", "fine"}
    for k in runs + exact:
        want = "direct_sin" if k.startswith("pallas_rm") else "recurrence"
        assert res["results"][k]["oracle"] == want, k
    for v in (res["bin_agreement_xla_vs_pallas"], res["bin_agreement_xla_vs_pallas_rm"]):
        assert set(v) == {"float32", "bfloat16"} and all(0.9 <= a <= 1.0 for a in v.values())
    lines = capsys.readouterr().out.splitlines()
    assert sum(" PASS launches=" in line for line in lines) == 12
    assert json.loads(lines[-1]) == {"all_pass": True}


def test_main_needs_a_gpu_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parity_gpu.main(["--rays", "8", "--coarse", "4", "--fine", "4", "--hidden", "16",
                         "--out", str(tmp_path / "p.json")])


def test_a_failing_path_fails_the_run(tmp_path, monkeypatch):
    """A kernel path whose gradient drifts from the oracle fails both checks
    and the exit code."""
    real = parity_gpu.loss_and_grads

    def drifting(problem, config):
        loss, grads = real(problem, config)
        if config.backend == "pallas_rm" and config.compute_dtype == torch.float32:
            grads["fine"]["rgb_out"]["bias"] = grads["fine"]["rgb_out"]["bias"] * 1.01
        return loss, grads

    monkeypatch.setattr(parity_gpu, "loss_and_grads", drifting)
    out = tmp_path / "p.json"
    rc = parity_gpu.main(["--device", "cpu", "--rays", "32", "--coarse", "4", "--fine", "8",
                          "--hidden", "16", "--out", str(out)])
    res = json.loads(out.read_text())["results"]
    assert rc == 1
    assert not res["pallas_rm/float32/exact"]["pass"]
    assert res["pallas_rm/float32"]["max_rel_grad_err_vs_oracle_by_net"]["fine"] > 1e-3
    assert res["pallas/float32/exact"]["pass"] and res["pallas_rm/bfloat16"]["pass"]
