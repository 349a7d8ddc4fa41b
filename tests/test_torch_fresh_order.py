"""The summation order of the bf16 tensor-core tile (``csrc/mlp_mma_tile.cuh``).

Every wide product of bf16 B1, B2 and B6 (and of B4, B5, B7 through the
ray-group loops) sums each 16-deep step of its contraction into a fresh f32
partial, which one round-to-nearest f32 add then adds to the accumulator
(``mma_step``). Here a model of that order, one step being 16 bf16 x bf16
products exact in f64, summed, rounded once to f32 and added in f32, runs B1's
forward and B2's dx / dd in the tile's order (the narrow heads as the tile's
two-thread f32 FMA chains) at small widths. They are held against the JAX
package's ``_forward_pallas`` / ``_backward_pallas`` in interpret mode, and
against the f64 evaluation of the same chain (the plain version with
``work=torch.float64``) no farther than ``chip_smoke.F64_FACTOR_BF16`` times
the plain f32 version. The source assertions pin the one summation rule.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.ops import raymarch_pallas as jrp
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc

CSRC = Path(rc.__file__).resolve().parent.parent / "csrc"
MMA_SRC = (CSRC / "mlp_mma_tile.cuh").read_text()
# Hidden layers 32 wide (two 16-deep steps a product), the flagship's
# encodings (xyz 33: three steps; view dirs 24: two).
CASES = [dict(hidden_dim=32, last_hidden_dim=32, n_angles=2),
         dict(hidden_dim=32, last_hidden_dim=32, n_angles=0)]
IDS = ["view_dirs", "xyz_only"]
# The rows held against JAX's kernels, and those held against the f64 chain:
# at these widths a rounding of an activation or gradient that lands on the
# other side moves a chain's normwise distance by about 1.5e-5 at 2,048 rows,
# and there both versions show none to a few such flips; 65,536 rows give
# them in the hundreds, so the two distances compare the orders of summation.
N_JAX, N_ROWS = 2048, 65536
# The tile against JAX's bf16 kernels: the forward to one bf16 ulp of the
# largest output (2^-8 relative: a sum in another order can flip one bf16
# rounding of an activation), dx / dd normwise to chip_smoke.TOL_ROWS["bfloat16"]
# (a flip of a leaky branch or of a rounded gradient moves its row whole).
FWD_TOL = 2.0 ** -8
ROWS_TOL = chip_smoke.TOL_ROWS["bfloat16"]
STEP = 16


def _bf(v):
    """``v`` rounded to bf16 (round to nearest even), as f64."""
    return torch.from_numpy(np.asarray(v, dtype=np.float32)).bfloat16().double().numpy()


def fresh_sum(pairs, acc=None):
    """The tile's accumulator of ``sum a @ w`` over ``pairs`` in order (the
    skip layer's and the view branch's two products share one): each 16-deep
    step's products exact in f64, summed, rounded once to f32, then added to
    the f32 accumulator with one round-to-nearest f32 add."""
    for a, w in pairs:
        for k0 in range(0, a.shape[1], STEP):
            part = (a[:, k0:k0 + STEP] @ w[k0:k0 + STEP]).astype(np.float32)
            acc = part if acc is None else (acc + part).astype(np.float32)
    return acc


def _fma(a, b, s):
    """fmaf(a, b, s) for bf16 a, b and f32 s: exact in f64, rounded once."""
    return (np.asarray(a, np.float64) * b + np.asarray(s, np.float64)).astype(np.float32)


def _two_thread_dot(a, w):
    """The narrow heads: two threads a row, each an FMA chain over every other
    column, their sums added (``forward_tile``'s sigma and rgb heads)."""
    s = [np.zeros(a.shape[0], np.float32), np.zeros(a.shape[0], np.float32)]
    for k in range(a.shape[1]):
        s[k % 2] = _fma(a[:, k], w[k], s[k % 2])
    return (s[0] + s[1]).astype(np.float32)


def _setup(case, seed=0):
    jcfg, cfg = jm.MLPConfig(**case), tm.MLPConfig(**case)
    jparams = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    ws, bs = rc.flatten_params(tm.params_from_jax(jparams), cfg, torch.bfloat16)
    rng = np.random.default_rng(seed + 1)
    ex = rng.normal(size=(N_ROWS, cfg.xyz_dim)).astype(np.float32)
    ed = rng.normal(size=(N_ROWS, cfg.dir_dim)).astype(np.float32) if cfg.uses_view_dirs else None
    g = (0.5 + rng.uniform(size=(N_ROWS, 4))).astype(np.float32)
    return jcfg, cfg, jparams, ws, bs, ex, ed, g


def tile_forward(cfg, ws, bs, x, d):
    """B1's ``forward_tile``: ``(out (n, 4) f32, post-activations)``. ``ws``
    (K, N) and x, d hold bf16 values in f64; ``bs`` f32."""
    alpha = np.float32(cfg.leaky_relu_alpha)
    bs = [np.asarray(b, np.float32) for b in bs]

    def act(acc, b):
        v = (acc + b).astype(np.float32)
        return _bf(np.where(v >= 0, v, alpha * v))

    acts, h = [], x
    for layer in range(8):
        pairs = ([(x, ws[4])] if layer == 4 else []) + [(h, ws[rc._trunk_w(layer)])]
        h = act(fresh_sum(pairs), bs[layer])
        acts.append(h)
    if cfg.uses_view_dirs:
        sig = ((_two_thread_dot(h, ws[12][:, 0]) + _two_thread_dot(d, ws[13][:, 0]))
               .astype(np.float32) + bs[10][0]).astype(np.float32)
        r = act(fresh_sum([(h, ws[9]), (d, ws[10])]), bs[8])
        acts.append(r)
        bo = bs[9]
    else:
        sig = (_two_thread_dot(h, ws[12][:, 0]) + bs[11][0]).astype(np.float32)
        r = act(fresh_sum([(h, ws[9])]), bs[8])
        acts.append(r)
        r = act(fresh_sum([(r, ws[10])]), bs[9])
        acts.append(r)
        bo = bs[10]
    rgb = [(_two_thread_dot(r, ws[11][:, j]) + bo[j]).astype(np.float32) for j in range(3)]
    return np.stack(rgb + [sig], -1), acts


def tile_backward(cfg, ws, bs, x, d, g):
    """B2's ``backward_tile``'s dx and dd: the forward recomputed in the same
    order, then ``backward_walk``'s products G W^T in the tile's order (the
    rank-1 sigma terms and the K = 3 rgb head as f32 FMAs)."""
    alpha = np.float32(cfg.leaky_relu_alpha)
    alpha_t = np.float32(_bf(alpha))
    _, acts = tile_forward(cfg, ws, bs, x, d)
    grgb, gsig_t = g[:, :3], np.float32(_bf(g[:, 3]))

    def head(acc, post):  # grad_tile, head = true
        tt = _bf(acc)
        return np.where(post >= 0, tt, _bf((alpha_t * tt).astype(np.float32)))

    def trunk(acc, post):  # grad_tile, head = false
        return _bf(np.where(post >= 0, acc, (alpha * acc).astype(np.float32)))

    def rank1(acc, w):  # add_rank1: acc += gsig_t w for each output column
        return _fma(gsig_t[:, None], w[None, :, 0], acc)

    s = np.zeros((x.shape[0], ws[11].shape[0]), np.float32)
    for j in range(3):
        s = _fma(grgb[:, j:j + 1], ws[11][None, :, j], s)
    G = head(s, acts[-1])  # g_rgb_h
    dd = None
    if cfg.uses_view_dirs:
        dd = rank1(fresh_sum([(G, ws[10].T)]), ws[13])
        acc = rank1(fresh_sum([(G, ws[9].T)]), ws[12])
    else:
        G = head(fresh_sum([(G, ws[10].T)]), acts[-2])  # g_r0
        acc = rank1(fresh_sum([(G, ws[9].T)]), ws[12])
    for layer in reversed(range(8)):
        G = trunk(acc, acts[layer])
        if layer == 4:
            dx_skip = fresh_sum([(G, ws[4].T)])
            acc = fresh_sum([(G, ws[5].T)])
        elif layer > 0:
            acc = fresh_sum([(G, ws[rc._trunk_w(layer)].T)])
        else:
            dx = (fresh_sum([(G, ws[0].T)]) + dx_skip).astype(np.float32)
    return dx, dd


def _np(ws):
    return [w.double().numpy() for w in ws]


def _normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fresh_step_forward_matches_jax_and_the_f64_chain(case):
    jcfg, cfg, jparams, ws, bs, ex, ed, _ = _setup(case)
    x = torch.tensor(ex).bfloat16()
    d = torch.tensor(ed).bfloat16() if ed is not None else None
    got, _ = tile_forward(cfg, _np(ws), bs, x.double().numpy(),
                          d.double().numpy() if d is not None else None)
    ref = np.asarray(jrp.apply_mlp_fused(jparams, jcfg, ex[:N_JAX],
                                         ed[:N_JAX] if ed is not None else None,
                                         compute_dtype=jnp.bfloat16))
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got[:N_JAX], ref, atol=FWD_TOL * scale, rtol=0)
    exact = rc._forward_plain(ws, bs, cfg, x, d, torch.bfloat16, torch.float64)[0].numpy()
    plain = rc.mlp_fwd_plain(ws, bs, cfg, x, d, torch.bfloat16).numpy()
    assert _normwise(got, exact) <= chip_smoke.F64_FACTOR_BF16 * _normwise(plain, exact)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fresh_step_input_grads_match_jax_and_the_f64_chain(case):
    jcfg, cfg, jparams, ws, bs, ex, ed, g = _setup(case)
    argnums = (0, 1) if ed is not None else (0,)
    jg = jax.grad(lambda xx, dd: jnp.sum(jrp.apply_mlp_fused(
        jparams, jcfg, xx, dd, compute_dtype=jnp.bfloat16) * g[:N_JAX]), argnums=argnums)(
        ex[:N_JAX], ed[:N_JAX] if ed is not None else None)
    x = torch.tensor(ex).bfloat16()
    d = torch.tensor(ed).bfloat16() if ed is not None else None
    dx, dd = tile_backward(cfg, _np(ws), bs, x.double().numpy(),
                           d.double().numpy() if d is not None else None, g)
    got = [dx] + ([dd] if d is not None else [])
    for a, b in zip(got, jg):
        assert _normwise(a[:N_JAX], b) <= ROWS_TOL
    exact = rc.mlp_bwd_plain(ws, bs, cfg, x, d, torch.tensor(g), torch.bfloat16,
                             work=torch.float64)[2:]
    plain = rc.mlp_bwd_plain(ws, bs, cfg, x, d, torch.tensor(g), torch.bfloat16)[2:]
    for a, p, e in zip(got, plain, exact):
        assert _normwise(a, e.numpy()) <= chip_smoke.F64_FACTOR_BF16 * _normwise(p.numpy(),
                                                                                e.numpy())


@pytest.mark.parametrize("depth", [32, 256])
def test_fresh_steps_sum_closer_to_exact_than_plain_f32(depth):
    """One product of bf16 operands at a hidden layer's depth of this test
    and of the flagship: the tile's order against torch's f32 product, both
    against the exact sum."""
    rng = np.random.default_rng(depth)
    a = _bf(rng.normal(size=(4096, depth)))
    w = _bf(rng.normal(size=(depth, 64)) / np.sqrt(depth))
    exact = a @ w
    plain = (torch.from_numpy(a).float() @ torch.from_numpy(w).float()).numpy()
    assert _normwise(fresh_sum([(a, w)]), exact) <= _normwise(plain, exact)


def test_fresh_sum_rounds_once_a_step():
    """A step of 16 products whose running f32 sum would lose the small terms
    keeps them: its partial is the exact sum rounded once."""
    a = np.ones((1, 32))
    w = np.array([2.0 ** 24] + [1.0] * 15 + [1.0] * 16)[:, None]
    # step 1: 2^24 + 15 rounds to 2^24 + 16 once (a running f32 sum gives
    # 2^24); step 2: 16 added in f32.
    assert fresh_sum([(a, w)])[0, 0] == np.float32(2.0 ** 24 + 32)
    running = np.float32(0)
    for v in w[:, 0]:
        running = np.float32(running + np.float32(v))
    assert running == np.float32(2.0 ** 24)


def test_every_bf16_product_of_the_tile_goes_into_a_fresh_partial():
    """``mma_step`` has no template parameter and issues its mma into a zeroed
    partial that f32 adds add to ``c``; no other ``mma_bf16`` call takes an
    accumulator, and no source of the kernels names another rule."""
    step = re.search(r"__device__ __forceinline__ void mma_step\(float \(&c\)\[4\], "
                     r"const uint32_t \(&a\)\[4\], uint32_t b0,\s+uint32_t b1\) \{\n(.*?)\n\}\n",
                     MMA_SRC, re.S)
    assert step is not None
    assert "template" not in MMA_SRC[max(0, step.start() - 40):step.start()]
    body = step.group(1)
    assert "float p[4] = {0.f, 0.f, 0.f, 0.f};" in body
    assert "mma_bf16(p, a, b0, b1);" in body
    assert "for (int e = 0; e < 4; ++e) c[e] += p[e];" in body
    calls = re.findall(r"\bmma_bf16\(([^;]*)\);", MMA_SRC)
    assert calls == ["p, a, b0, b1"]  # the one call outside its definition, into p
    assert len(re.findall(r"\bmma_step\(", MMA_SRC)) == 1 + 4  # definition, 2 in mma_rows, 2 in mma_wgrad
    for src in CSRC.glob("*.cu*"):
        assert "FRESH" not in src.read_text(), src.name
        assert "mma_step<" not in src.read_text(), src.name
