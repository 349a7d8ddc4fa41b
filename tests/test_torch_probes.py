"""Port vs JAX package: the seven probe kernels and their tools.

On the CPU the probes' wrappers run their plain PyTorch versions; those are
held against the JAX package's Pallas probes (``tools/exp_mxu.py``,
``exp_vpu.py``, ``exp_interleave.py``, ``exp_expand.py``, ``exp_enccost.py``)
run in interpret mode on the same inputs, made with numpy from a seed. The
JAX tools are reached without editing them: ``pallas_call`` is wrapped to add
``interpret=True`` and to record what each call returned (the expand and
encode-cost tools return only sums), their module constants are shrunk, and
the three names ``exp_enccost`` looks up on the wrong module are set there.
The CUDA kernels themselves are held against the same plain versions on the
GPU by ``chip_smoke.py``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerf_and_dietnerf_tpu.models import mlp as jm
from nerf_and_dietnerf_tpu.ops import raymarch_pallas as jrp
from nerf_and_dietnerf_tpu.ops import research_kernels as jrk
from nerf_and_dietnerf_tpu_torch import tools as ttools
from nerf_and_dietnerf_tpu_torch.models import mlp as tm
from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
from nerf_and_dietnerf_tpu_torch.ops import probe_kernels_cuda as pk
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
from nerf_and_dietnerf_tpu_torch.tools import (
    exp_enccost,
    exp_expand,
    exp_interleave,
    exp_mxu,
    exp_vpu,
)

ROOT = Path(__file__).resolve().parent.parent
MLP = dict(hidden_dim=32, last_hidden_dim=16, n_freq_xyz=5, n_freq_dir=4, n_angles=2)
BF16_ULP = 2.0 ** -8  # one bf16 ulp, relative to the largest entry


def jax_tool(name):
    """The JAX package's ``tools/<name>.py`` as a module (``tools/`` is a
    directory of scripts, not a package)."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpreted(monkeypatch):
    """Every ``pl.pallas_call`` runs in interpret mode; returns the list that
    collects ``(inputs, outputs)`` of each call, as numpy arrays."""
    calls = []
    real = pl.pallas_call

    def pallas_call(kernel, *args, **kwargs):
        fn = real(kernel, *args, **{**kwargs, "interpret": True})

        def run(*inputs):
            out = fn(*inputs)
            calls.append(([np.asarray(a) for a in inputs], np.asarray(out)))
            return out

        return run

    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    return calls


@pytest.fixture
def numpy_random(monkeypatch):
    """``jax.random.normal`` draws from a numpy generator, so the inputs the
    JAX tools make for themselves come from a numpy seed."""
    rng = np.random.default_rng(7)

    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32), dtype)

    monkeypatch.setattr(jax.random, "normal", normal)


def _mlp_setup(n_rows, seed=3):
    jcfg, tcfg = jm.MLPConfig(**MLP), tm.MLPConfig(**MLP)
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, jcfg.xyz_dim)).astype(np.float32)
    d = rng.normal(size=(n_rows, jcfg.dir_dim)).astype(np.float32)
    ws, bs = rc.flatten_params(tm.params_from_jax(params), tcfg, torch.bfloat16)
    return jcfg, tcfg, params, x, d, ws, bs


# --------------------------------------------------------------------------- #
# P1                                                                           #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("m,depth,chains", [(64, 4, 1), (64, 8, 2), (64, 8, 4)])
def test_mxu_chain_matches_jax_probe(interpreted, numpy_random, capsys, m, depth, chains):
    steps = 2
    with jax.disable_jit():
        jax_tool("exp_mxu").run(m, depth, chains, steps=steps)
    (w,), ref = interpreted[0]
    assert ref.shape == (steps * 8, 256) and np.abs(ref).max() > 0
    tw = pk.tensors_from_jax({"w": w}, bf16=("w",))["w"]
    assert tw.dtype == torch.bfloat16
    np.testing.assert_array_equal(tw.float().numpy(), np.asarray(w, np.float32))
    got = pk.mxu_chain(tw, m, depth, chains, steps)
    assert got.shape == ref.shape and got.dtype == torch.float32
    # bf16 roundings of a layer's sums can differ by one ulp between the two
    # frameworks' f32 summation orders; the column sums add m such rows.
    np.testing.assert_allclose(got.numpy(), ref, atol=np.abs(ref).max() * BF16_ULP)
    np.testing.assert_array_equal(got.numpy(), pk.mxu_chain_plain(tw, m, depth, chains, steps))
    assert "TF/s" in capsys.readouterr().out


def test_mxu_chain_checks_its_arguments():
    w = torch.zeros((256, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        pk.mxu_chain(w, 24, 4, 1)
    assert float(pk.mxu_chain(w, 16, 4, 2, steps=1).abs().max()) == 0.0


# --------------------------------------------------------------------------- #
# P2, P3                                                                       #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("variant", ["v1", "v5", "v3"])
def test_mlp_fwd_variant_matches_jax_probe(interpreted, monkeypatch, variant):
    jcfg, tcfg, params, x, d, ws, bs = _mlp_setup(256)
    tool = jax_tool("exp_vpu")
    monkeypatch.setattr(tool, "TILE", 128)
    ref = np.asarray(tool.fwd_pallas(params, jcfg, jnp.asarray(x), jnp.asarray(d), variant))
    got = pk.mlp_fwd_variant(ws, bs, tcfg, torch.tensor(x), torch.tensor(d), variant)
    assert got.shape == (256, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=np.abs(ref).max() * BF16_ULP)
    if variant == "v3":  # max-form leaky is B1's leaky for 0 < alpha < 1
        b1 = rc.mlp_fwd(ws, bs, tcfg, torch.tensor(x).bfloat16(), torch.tensor(d).bfloat16(),
                        torch.bfloat16)
        np.testing.assert_array_equal(got.numpy(), b1.numpy())
    with pytest.raises(ValueError, match="variant"):
        pk.mlp_fwd_variant(ws, bs, tcfg, torch.tensor(x), torch.tensor(d), "v2")


@pytest.mark.parametrize("chains", [1, 2, 4])
def test_mlp_fwd_chains_matches_b1_and_jax_probe(interpreted, chains):
    jcfg, tcfg, params, x, d, ws, bs = _mlp_setup(256)
    ref = np.asarray(jax_tool("exp_interleave").fwd_pallas(
        params, jcfg, jnp.asarray(x), jnp.asarray(d), 128, chains))
    tx, td = torch.tensor(x).bfloat16(), torch.tensor(d).bfloat16()
    got = pk.mlp_fwd_chains(ws, bs, tcfg, tx, td, chains)
    np.testing.assert_array_equal(
        got.numpy(), rc.mlp_fwd_plain(ws, bs, tcfg, tx, td, torch.bfloat16).numpy())
    np.testing.assert_allclose(got.numpy(), ref, atol=np.abs(ref).max() * BF16_ULP)
    with pytest.raises(ValueError, match="1, 2 or 4"):
        pk.mlp_fwd_chains(ws, bs, tcfg, tx, td, 3)


# --------------------------------------------------------------------------- #
# P4, P5, P6                                                                   #
# --------------------------------------------------------------------------- #

@pytest.fixture
def jax_expand(interpreted, numpy_random, monkeypatch):
    """``tools/exp_expand.py`` at 8 rays x 4 samples a tile, each probe run
    once (its ``bench`` loops a jitted scan)."""
    tool = jax_tool("exp_expand")
    for name, value in (("R_T", 8), ("S", 4), ("ROWS", 32)):
        monkeypatch.setattr(tool, name, value)
    monkeypatch.setattr(tool, "bench", lambda fn, *args: float(fn(*args, jnp.float32(0.0))))
    return tool


def test_expand_a_matches_jax_probe(jax_expand, interpreted):
    jax_expand.probe_a()
    (zt,), ref = interpreted[0]
    got = pk.expand_a(torch.tensor(zt))
    assert got.shape == (32, 1)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_expand_b_matches_jax_probe(jax_expand, interpreted):
    jax_expand.probe_b()
    (rd,), ref = interpreted[0]
    got = pk.expand_b(torch.tensor(rd), 4)
    assert got.shape == (32, 8)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_expand_c_matches_jax_probe(jax_expand, interpreted):
    jax_expand.probe_c()  # the tool fixes its own tile count (16)
    inputs, ref = interpreted[0]
    t = pk.tensors_from_jax(dict(zip(("px", "py", "pz", "vc", "sc", "gx"), inputs)))
    got = pk.expand_c(t["px"], t["py"], t["pz"], t["vc"], t["sc"], t["gx"])
    assert got.shape == ref.shape == (16 * 32, 33)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------- #
# P7                                                                           #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("stage", pk.ENC_STAGES)
def test_enc_cost_matches_jax_probe(interpreted, monkeypatch, stage):
    r_t, n_s, n_tiles = 8, 8, 2
    tool = jax_tool("exp_enccost")
    for name, value in (("R_T", r_t), ("S", n_s), ("ROWS", r_t * n_s), ("N_TILES", n_tiles)):
        monkeypatch.setattr(tool, name, value)
    # The tool looks these up on raymarch_pallas; they live in research_kernels.
    for name in ("_enc_layout", "_expand_consts", "_const_spec"):
        monkeypatch.setattr(jrp, name, getattr(jrk, name), raising=False)
    rng = np.random.default_rng(11)
    rd = rng.normal(size=(n_tiles * r_t, 9)).astype(np.float32)
    z = rng.uniform(2.0, 6.0, size=(n_tiles * r_t, n_s)).astype(np.float32)
    fn, _ = tool.make_probe(stage)
    with jax.disable_jit():
        fn(jnp.asarray(rd), jnp.asarray(z), jnp.float32(0.0))
    (_, _, f2, masks, offs), ref = interpreted[0]
    assert ref.shape == (n_tiles * r_t * n_s, 4)

    # The port's own copy of the layout constants is the JAX package's.
    lay = pk.enc_layout(tm.MLPConfig())
    np.testing.assert_array_equal(lay["masks"], masks)
    np.testing.assert_array_equal(lay["offs"], offs)
    np.testing.assert_array_equal(pk.expand_f2(r_t, n_s), f2)

    trd, tz = torch.tensor(rd), torch.tensor(z)
    got = pk.enc_cost(trd, tz, stage, r_t=r_t)
    consts = pk.tensors_from_jax({"masks": masks, "offs": offs, "F2": f2})
    np.testing.assert_array_equal(
        got.numpy(), pk.enc_cost_plain(trd, tz, stage, r_t=r_t, consts=consts).numpy())
    if stage == "enc":
        np.testing.assert_allclose(got.numpy(), ref, atol=np.abs(ref).max() * BF16_ULP)
    elif stage == "sin":
        # The angles agree (stage "theta"); XLA's CPU sine reduces its range in
        # f32, which costs up to an f32 ulp of the angle (hundreds of radians).
        theta = pk.enc_cost_plain(trd, tz, "theta", r_t=r_t)
        atol = 1e-5 + float(theta.abs().max()) * 2.0 ** -23
        np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_enc_cost_checks_its_arguments():
    rd, z = torch.zeros((8, 9)), torch.zeros((8, 4))
    with pytest.raises(ValueError, match="stage"):
        pk.enc_cost(rd, z, "cos", r_t=8)
    with pytest.raises(ValueError, match="whole tiles"):
        pk.enc_cost(rd, z, "pts", r_t=3)
    with pytest.raises(ValueError, match="view-dir"):
        pk.enc_cost(rd, z, "pts", tm.MLPConfig(n_angles=0), r_t=8)


# --------------------------------------------------------------------------- #
# Wrappers and tools                                                           #
# --------------------------------------------------------------------------- #

def test_wrappers_raise_on_device_they_cannot_serve():
    _, tcfg, _, _, _, ws, bs = _mlp_setup(8)
    meta = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
        shape, device="meta", dtype=dtype)
    x, d = meta(8, tcfg.xyz_dim), meta(8, tcfg.dir_dim)
    before = dict(kl.LAUNCHES)
    for call in (
            lambda: pk.mxu_chain(meta(256, 256, dtype=torch.bfloat16), 16, 4, 1),
            lambda: pk.mlp_fwd_variant(ws, bs, tcfg, x, d, "v1"),
            lambda: pk.mlp_fwd_chains(ws, bs, tcfg, x, d, 2),
            lambda: pk.expand_a(meta(4, 8)),
            lambda: pk.expand_b(meta(8, 8), 4),
            lambda: pk.expand_c(meta(8, 8), meta(8, 8), meta(8, 8), meta(16, 3), meta(6, 10),
                                meta(10, 5)),
            lambda: pk.enc_cost(meta(8, 9), meta(8, 4), "pts", r_t=8)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert kl.LAUNCHES == before
    assert {"probe_mma", "probe_mlp_epilogue", "probe_mlp_chains", "probe_expand_a",
            "probe_expand_b", "probe_expand_c", "probe_enccost"} <= set(kl.LAUNCHES)
    assert len(kl.KERNEL_SOURCES) == 14 and len(kl.LAUNCHES) == 16


TOOL_RUNS = [
    (exp_mxu, ["--cases", "64:4:1", "64:8:2", "--steps", "2"], ["M=   64 depth= 4 chains=1",
                                                                 "M=   64 depth= 8 chains=2"]),
    (exp_vpu, ["--rows", "192"], ["v0 baseline", "v1 ", "v5 ", "v3 "]),
    (exp_interleave, ["--rows", "192"], ["tile=   64 chains=1", "tile=  128 chains=2",
                                         "tile=  256 chains=4"]),
    (exp_expand, ["--r-t", "8", "--samples", "4", "--tiles", "2"],
     ["A reshape:", "B repeat:", "C encode:"]),
    (exp_enccost, ["--r-t", "8", "--samples", "4", "--tiles", "2"],
     [f"{s:7s}:" for s in pk.ENC_STAGES]),
]


@pytest.mark.parametrize("tool,argv,starts", TOOL_RUNS,
                         ids=[t[0].__name__.rsplit(".", 1)[-1] for t in TOOL_RUNS])
def test_tool_prints_one_line_per_case_on_the_cpu(capsys, tool, argv, starts):
    assert tool.main(["--device", "cpu", "--reps", "1", *argv]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(starts)
    for line, start in zip(lines, starts):
        assert line.startswith(start), line
        assert line.endswith("[cpu: plain version, host clock]") and "FAILED" not in line


def test_tools_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tools run on it")
    for tool in (exp_mxu, exp_vpu, exp_interleave, exp_expand, exp_enccost):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main([])
    assert ttools.peak_share(1e12, 1.0, torch.device("cpu")) == "n/a"


def test_interleave_tool_reports_only_the_shared_memory_refusal(monkeypatch, capsys):
    real = exp_interleave.mlp_fwd_chains

    def refuse_four(ws, bs, config, x, d, n_chains):
        if n_chains == 4:
            raise pk.SharedMemoryExceeded("4 chains need too much")
        return real(ws, bs, config, x, d, n_chains)

    monkeypatch.setattr(exp_interleave, "mlp_fwd_chains", refuse_four)
    assert exp_interleave.main(["--device", "cpu", "--reps", "1", "--rows", "64"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [("FAILED" in line) for line in lines] == [False, False, True]
    assert lines[2].startswith("tile=256 chains=4  FAILED 4 chains need too much")

    def bad_input(*args):
        raise ValueError("expected (64, 33)")

    monkeypatch.setattr(exp_interleave, "mlp_fwd_chains", bad_input)
    with pytest.raises(ValueError, match="expected"):
        exp_interleave.main(["--device", "cpu", "--reps", "1", "--rows", "64"])
