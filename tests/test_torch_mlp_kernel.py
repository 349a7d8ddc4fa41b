"""Port vs JAX package: the radiance MLP, its kernel wrappers and ``.h5`` I/O.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX package's fused Pallas kernel run in interpret mode, as
``tests/test_pallas_kernel.py`` runs it. The CUDA kernels themselves are
held against the same plain versions on the GPU by ``chip_smoke.py``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.ops import raymarch_pallas as jrp
from nerf_and_dietnerf_tpu.train import checkpoint as jckpt
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
from nerf_and_dietnerf_tpu_torch.train import checkpoint as tckpt
from nerf_and_dietnerf_tpu_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
FLAGSHIP_H5 = ROOT / "runs" / "256px_alexander_nerf_r04" / "NeRF_model_epoch_070.h5"
DIET_H5 = ROOT / "runs" / "diet_ab_50px" / "nerf" / "NeRF_model_epoch_095.h5"

CASES = [
    dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=2, n_freq_dir=2, n_angles=2),
    dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=2, n_angles=0),
]
IDS = ["view_dirs", "xyz_only"]
# f32 products and sums in both; only the summation order differs.
FWD_TOL = 2e-5
BWD_TOL = 5e-5  # scaled by each leaf's max |value|


def _setup(case, n, seed=1):
    jcfg, tcfg = jm.MLPConfig(**case), tm.MLPConfig(**case)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    ex = rng.normal(size=(n, jcfg.xyz_dim)).astype(np.float32)
    ed = rng.normal(size=(n, jcfg.dir_dim)).astype(np.float32) if jcfg.uses_view_dirs else None
    return jcfg, tcfg, params, ex, ed


def _t(a, grad=False):
    return None if a is None else torch.tensor(np.asarray(a)).requires_grad_(grad)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_twin_matches_jax_fused(case):
    jcfg, tcfg, params, ex, ed = _setup(case, 130)
    ref = np.asarray(jrp.apply_mlp_fused(params, jcfg, ex, ed, compute_dtype=jnp.float32))
    tp = tm.params_from_jax(params)
    ws, bs = rc.flatten_params(tp, tcfg, torch.float32)
    got = rc.mlp_fwd(ws, bs, tcfg, _t(ex), _t(ed), torch.float32)
    assert got.shape == (130, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=FWD_TOL, rtol=FWD_TOL)
    via_fn = rc.apply_mlp_fused(tp, tcfg, _t(ex), _t(ed), compute_dtype=torch.float32)
    np.testing.assert_array_equal(via_fn.numpy(), got.numpy())
    plain = tm.apply_mlp(tp, tcfg, _t(ex), _t(ed), compute_dtype=torch.float32)
    np.testing.assert_allclose(plain.numpy(), ref, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_twin_and_autograd_match_jax_fused(case):
    jcfg, tcfg, params, ex, ed = _setup(case, 96)
    g = np.random.default_rng(3).normal(size=(96, 4)).astype(np.float32)
    argnums = (0, 1, 2) if jcfg.uses_view_dirs else (0, 1)
    jg = jax.grad(
        lambda p, x, d: jnp.sum(jrp.apply_mlp_fused(p, jcfg, x, d, compute_dtype=jnp.float32) * g),
        argnums=argnums,
    )(params, ex, ed)

    tp = tm.params_from_jax(params)
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    x, d = _t(ex, True), _t(ed, jcfg.uses_view_dirs)
    out = rc.apply_mlp_fused(tp, tcfg, x, d, compute_dtype=torch.float32)
    (out * _t(g)).sum().backward()
    got = [leaf.grad for leaf in leaves] + [x.grad] + ([d.grad] if d is not None else [])
    ref = jax.tree.leaves(jg[0]) + [jg[1]] + ([jg[2]] if d is not None else [])
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        scale = max(1e-6, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=BWD_TOL)

    # The wrapper's flat gradients reassemble to the same tree.
    with torch.no_grad():
        ws, bs = rc.flatten_params(tp, tcfg, torch.float32)
        dws, dbs, dx, dd = rc.mlp_bwd(ws, bs, tcfg, x, d, _t(g), torch.float32)
    tree = rc.unflatten_grads(dws, dbs, tcfg)
    for a, b in zip(tree_leaves(tree), [leaf.grad for leaf in leaves]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(dx.numpy(), x.grad.numpy())


def test_bf16_twin_matches_jax_bf16_forward():
    """bf16 operands: the plain version rounds where the JAX kernel rounds."""
    jcfg, tcfg, params, ex, ed = _setup(CASES[0], 130)
    ref = np.asarray(jrp.apply_mlp_fused(params, jcfg, ex, ed, compute_dtype=jnp.bfloat16))
    got = rc.apply_mlp_fused(tm.params_from_jax(params), tcfg, _t(ex), _t(ed),
                             compute_dtype=torch.bfloat16)
    # One bf16 ulp of the largest output (2^-8 relative) covers a rounding
    # of an activation that lands on the other side in the two libraries.
    np.testing.assert_allclose(got.numpy(), ref, atol=np.abs(ref).max() * 2 ** -8)


def _jax_and_port_h5(path, case):
    jcfg, tcfg = jm.MLPConfig(**case), tm.MLPConfig(**case)
    return jcfg, tcfg, jckpt.load_keras_h5(path, jcfg), tckpt.load_keras_h5(path, tcfg)


def test_full_width_h5_weights_match_jax():
    jcfg, tcfg, jp, tp = _jax_and_port_h5(FLAGSHIP_H5, {})
    jl, tl = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl) == 44
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tm.count_params(tp["coarse"]) == jm.count_params(jp["coarse"])
    for a, b in zip(jax.tree.leaves(tm.params_to_jax(tp)), jl):
        np.testing.assert_array_equal(a, np.asarray(b))

    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    dirs = rng.normal(size=(512, 3)).astype(np.float32)
    from nerf_and_dietnerf_tpu.core import encoding as jenc

    ex = np.asarray(jenc.encode_xyz(jnp.asarray(pts), 5))
    ed = np.asarray(jenc.encode_view_dirs(jnp.asarray(dirs), 4))
    for which in ("coarse", "fine"):
        ref = np.asarray(jrp.apply_mlp_fused(jp[which], jcfg, ex, ed, compute_dtype=jnp.float32))
        got = rc.apply_mlp_fused(tp[which], tcfg, _t(ex), _t(ed), compute_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_h5_round_trip_is_read_by_jax(tmp_path):
    case = dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=2, n_freq_dir=2)
    jcfg, tcfg, _, tp = _jax_and_port_h5(DIET_H5, {})  # any committed file
    params = {"coarse": tm.init_params(torch.Generator().manual_seed(1), tm.MLPConfig(**case)),
              "fine": tm.init_params(torch.Generator().manual_seed(2), tm.MLPConfig(**case))}
    path = tmp_path / "saved_weights" / "NeRF_model_epoch_001.h5"
    tckpt.save_keras_h5(path, params, tm.MLPConfig(**case))
    back = jckpt.load_keras_h5(path, jm.MLPConfig(**case))
    for a, b in zip(jax.tree.leaves(back), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert len(tree_leaves(tp)) == 44  # the committed DietNeRF-run file loads too


def test_wrapper_raises_on_device_it_cannot_serve():
    cfg = tm.MLPConfig(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=2, n_freq_dir=2)
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    ws, bs = rc.flatten_params(params, cfg, torch.float32)
    x = torch.empty((8, cfg.xyz_dim), device="meta")
    d = torch.empty((8, cfg.dir_dim), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rc.mlp_fwd(ws, bs, cfg, x, d, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        rc.mlp_bwd(ws, bs, cfg, x, d, torch.empty((8, 4), device="meta"), torch.float32)
    assert kl.LAUNCHES["mlp_fwd"] == kl.LAUNCHES["mlp_bwd"] == 0
