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

import ctypes
import importlib.util
from pathlib import Path
from types import SimpleNamespace

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
    probe_cuts,
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


def _descriptor_read(pack: torch.Tensor) -> torch.Tensor:
    """W (256 K, 256 N) as the kernel's ``wgmma`` reads it from the pack: k-step
    kk's descriptor starts at byte 8192 kk; entry (n, k) of the k-step sits at
    (n // 8) * 256 (stride byte offset) + (k // 8) * 128 (leading byte offset)
    + (n % 8) * 16 + (k % 8) * 2 bytes."""
    n = torch.arange(256).view(1, 256, 1)
    kk, kl_ = torch.arange(16).view(16, 1, 1), torch.arange(16).view(1, 1, 16)
    byte = kk * 8192 + (n // 8) * 256 + (kl_ // 8) * 128 + (n % 8) * 16 + (kl_ % 8) * 2
    bt = pack[byte // 2]  # (kk, n, k within the step)
    return bt.permute(0, 2, 1).reshape(256, 256)


def test_mxu_pack_is_w_in_the_descriptors_layout():
    w = torch.tensor(np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32)).to(
        torch.bfloat16)
    pack = pk.mxu_pack(w)
    assert pack.shape == (65536,) and pack.dtype == torch.bfloat16
    assert torch.equal(_descriptor_read(pack), w)
    header = (ROOT / "nerf_and_dietnerf_tpu_torch" / "csrc" / "wgmma_bf16.cuh").read_text()
    assert ("  return (k / KSTEP) * np * KSTEP + (n / 8) * 128 + ((k % KSTEP) / 8) * 64 + "
            "(n % 8) * 8 + k % 8;") in header
    assert "constexpr uint32_t GROUP_BYTES = 256;" in header
    n, k = torch.meshgrid(torch.arange(256), torch.arange(256), indexing="ij")
    offs = pk.kmajor_offset(n, k, 256).reshape(-1)
    assert torch.equal(offs.sort().values, torch.arange(65536))


def _bf_np(a):
    return np.asarray(torch.tensor(a, dtype=torch.float32).to(torch.bfloat16).float())


def _emulated_chain(pack, m, depth, n_chains, steps):
    """The kernel's arithmetic from the pack, unit by unit in its order: a
    unit is a 64-row tile of one chain (rows past m computed, left out of the
    sums); the layer's f32 sums rounded and scaled into bf16; a unit's column
    sums over its warps in warp order; a step's units added in unit order."""
    wt = _descriptor_read(pack).float().numpy()
    s = _bf_np(0.01)
    col = np.arange(256, dtype=np.float32)
    tiles = -(-m // 64)
    out = np.zeros((steps * 8, 256), np.float32)
    for step in range(steps):
        total = np.zeros(256, np.float32)
        for tile in range(tiles):
            for c in range(n_chains):
                h = np.repeat(_bf_np(col * np.float32(0.001 * (c + 1)))[None], 64, axis=0)
                for _ in range(depth // n_chains):
                    h = _bf_np(_bf_np(h @ wt) * s)
                rows = np.arange(64) + 64 * tile < m
                warps = [h[16 * i:16 * i + 16].sum(axis=0, dtype=np.float32) * rows[16 * i]
                         for i in range(4)]
                total = total + ((warps[0] + warps[1]) + warps[2]) + warps[3]
        out[8 * step:8 * step + 8] = total
    return out


@pytest.mark.parametrize("m,depth,chains", [(48, 4, 1), (64, 8, 4), (144, 2, 2)])
def test_mxu_chain_kernels_units_match_jax_probe(interpreted, numpy_random, m, depth, chains):
    steps = 2
    with jax.disable_jit():
        jax_tool("exp_mxu").run(m, depth, chains, steps=steps)
    (w,), ref = interpreted[0]
    tw = pk.tensors_from_jax({"w": w}, bf16=("w",))["w"]
    got = _emulated_chain(pk.mxu_pack(tw), m, depth, chains, steps)
    np.testing.assert_allclose(got, ref, atol=np.abs(ref).max() * BF16_ULP)
    np.testing.assert_allclose(got, pk.mxu_chain_plain(tw, m, depth, chains, steps).numpy(),
                               atol=np.abs(ref).max() * BF16_ULP)


@pytest.mark.parametrize("probe,cut", [(p, c) for p, (_, cuts) in probe_cuts.CUTS.items()
                                       for c in cuts])
def test_probe_cuts_apply_to_the_kernels_sources(probe, cut):
    """Each cut of the measurement tool edits text that occurs once in the
    kernel's source; a stamped copy gains the C function that reads its
    stamps."""
    library, cuts = probe_cuts.CUTS[probe]
    src = probe_cuts.cut_source(library, cuts[cut])
    assert src != (kl.CSRC_DIR / kl.KERNEL_SOURCES[library]).read_text()
    assert ('extern "C" int nerf_probe_stamps(' in src) == (cut == "stamped")
    with pytest.raises(ValueError, match="occurs 0 times"):
        probe_cuts.cut_source(library, [("no such text", "")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            probe_cuts.main([])


def test_bf16_wgmma_header_stays_out_of_the_model_kernels():
    csrc = ROOT / "nerf_and_dietnerf_tpu_torch" / "csrc"
    header = csrc / "wgmma_bf16.cuh"
    assert header in kl.source_closure(csrc / kl.KERNEL_SOURCES["probe_mma"])
    for name, src in kl.KERNEL_SOURCES.items():
        if not name.startswith("probe_"):
            assert header not in kl.source_closure(csrc / src), name
    src = (csrc / "probe_mma.cu").read_text()
    assert "mma.sync" not in src.split("#include", 1)[1]
    assert "wgmma_m64n256k16(d, a[kk], desc0 + (uint64_t)(kk * (KSTEP_BYTES >> 4)), kk);" in src


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


MMA_TILE_SRC = (ROOT / "nerf_and_dietnerf_tpu_torch" / "csrc" / "mlp_mma_tile.cuh").read_text()


def _tile_int(expr):
    """An ``int`` constant of ``mlp_mma_tile.cuh`` (its expression evaluated
    over the constants before it)."""
    import re

    consts = {}
    for name, value in re.findall(r"^constexpr int (\w+) = ([^;]+);", MMA_TILE_SRC, re.M):
        consts[name] = eval(value, {}, dict(consts))
    return eval(expr, {}, consts)


def header_chains_smem(n_chains):
    """``nerf_mma::fwd_smem_bytes<WM>()`` at WM = ``n_chains``, as the header
    computes it (what ``nerf_probe_chains_smem`` returns)."""
    assert "template <int WM> constexpr int BM_OF = 64 * WM;" in MMA_TILE_SRC
    assert ("  constexpr size_t rows = BM_OF<WM>;\n  return 2 * (rows * LDH + rows * LDX + rows * "
            "LDD + NSTAGE * HPAD * LDW) + 4 * rows;") in MMA_TILE_SRC
    rows = 64 * n_chains
    return 2 * (rows * _tile_int("LDH") + rows * _tile_int("LDX") + rows * _tile_int("LDD")
                + _tile_int("NSTAGE * HPAD * LDW")) + 4 * rows


@pytest.mark.parametrize("chains", [1, 2, 4])
def test_chains_shared_memory_mirror_matches_the_tile(chains):
    """The wrapper's mirror of the chains' tile: one and two chains fit a
    block (two are B1's own tile, 137,728 bytes as the header states), four
    exceed its shared memory and, at the 200 registers a thread that ptxas
    gives the two-chain instance, the register file too."""
    need = pk.chains_smem_bytes(chains)
    assert need == header_chains_smem(chains)
    assert need == chains * 48384 + 40960
    if chains == 2:
        assert "+ sigma 512 = 137,728;" in MMA_TILE_SRC and need == 137728
    limits, with_registers = pk.chains_limits(chains), pk.chains_limits(chains, registers=200)
    if chains < 4:
        assert need <= pk.MAX_SHARED_BYTES == 232448 and limits == with_registers == []
    else:
        assert need == 234496 > pk.MAX_SHARED_BYTES
        assert len(limits) == 1 and "234496 bytes of shared memory" in limits[0]
        assert with_registers[0] == limits[0] and len(with_registers) == 2
        assert "512 threads of 200 registers" in with_registers[1]
        assert "each 128" in with_registers[1]
        assert pk.chains_limits(chains, registers=128)[1:] == []


class _FakeProbeLib:
    """The P2 / P3 libraries' exports as their sources compute them, and
    launches that record their arguments."""

    def __init__(self, config):
        self.pack = rc.mma_layout(config)[1]
        self.calls = []

    def nerf_mlp_mma_pack_elems(self, *dims):
        return self.pack

    def nerf_probe_chains_smem(self, n_chains):
        return header_chains_smem(n_chains)

    def nerf_probe_mlp_chains(self, *args):
        self.calls.append(("chains", args))
        return 0

    def nerf_probe_mlp_epilogue(self, *args):
        self.calls.append(("epilogue", args))
        return 0


@pytest.fixture
def fake_probe_card(monkeypatch):
    """The P2 / P3 wrappers on CPU tensors as on the card: a fake library
    and stream; the launch counts are restored afterwards."""
    _, tcfg, _, _, _, _, _ = _mlp_setup(8)
    lib = _FakeProbeLib(tcfg)
    monkeypatch.setattr(pk, "uses_kernel", lambda t: True)
    monkeypatch.setattr(pk, "load", lambda name: lib)
    monkeypatch.setattr(pk, "stream_of", lambda dev: 0)
    counts = dict(kl.LAUNCHES)
    yield lib
    kl.LAUNCHES.update(counts)


@pytest.mark.parametrize("chains", [1, 2, 4])
def test_chains_wrapper_launches_what_fits_and_refuses_four(fake_probe_card, chains):
    _, tcfg, _, x, d, ws, bs = _mlp_setup(200)
    tx, td = torch.tensor(x).bfloat16(), torch.tensor(d).bfloat16()
    before = kl.LAUNCHES["probe_mlp_chains"]
    if chains == 4:
        with pytest.raises(pk.SharedMemoryExceeded, match="234496 bytes of shared memory"):
            pk.mlp_fwd_chains(ws, bs, tcfg, tx, td, chains)
        assert fake_probe_card.calls == [] and kl.LAUNCHES["probe_mlp_chains"] == before
        return
    out = pk.mlp_fwd_chains(ws, bs, tcfg, tx, td, chains)
    assert out.shape == (200, 4) and out.dtype == torch.float32
    ((kind, args),) = fake_probe_card.calls
    assert kind == "chains" and args[0] == chains
    assert args[6:] == (200, tcfg.xyz_dim, tcfg.dir_dim, tcfg.hidden_dim,
                        tcfg.last_hidden_dim, tcfg.leaky_relu_alpha, 0)
    assert kl.LAUNCHES["probe_mlp_chains"] == before + 1
    # A library that counts the tile's bytes otherwise is refused.
    fake_probe_card.nerf_probe_chains_smem = lambda c: 1
    with pytest.raises(RuntimeError, match="disagree"):
        pk.mlp_fwd_chains(ws, bs, tcfg, tx, td, chains)


@pytest.mark.parametrize("variant", sorted(pk.MLP_VARIANTS))
def test_epilogue_wrapper_passes_b1s_weight_pack(fake_probe_card, monkeypatch, variant):
    _, tcfg, _, x, d, ws, bs = _mlp_setup(200)
    seen = []
    real = pk._weights_for

    def weights_for(lib, ws_, config, cd, kinds):
        seen.append((cd, kinds))
        return real(lib, ws_, config, cd, kinds)

    monkeypatch.setattr(pk, "_weights_for", weights_for)
    pk.mlp_fwd_variant(ws, bs, tcfg, torch.tensor(x), torch.tensor(d), variant)
    ((kind, args),) = fake_probe_card.calls
    assert kind == "epilogue" and args[0] == pk.MLP_VARIANTS[variant]
    assert seen == [(torch.bfloat16, ("f",))]  # the F pack, as bf16 B1 reads it
    fake_probe_card.pack += 16
    with pytest.raises(RuntimeError, match="weight-pack layout"):
        pk.mlp_fwd_variant(ws, bs, tcfg, torch.tensor(x), torch.tensor(d), variant)


def test_epilogue_and_chains_probes_run_b1s_tensor_core_tile():
    """P2 and P3 instantiate bf16 B1's forward_tile (mlp_mma_tile.cuh) and
    include nothing of the FMA tile's header; f32 B6's forward at wide
    encodings is the FMA forward_tile's only caller."""
    csrc = ROOT / "nerf_and_dietnerf_tpu_torch" / "csrc"
    for name, call in (("probe_mlp_epilogue.cu", "forward_tile<Epi>("),
                       ("probe_mlp_chains.cu", "forward_tile<LeakyEpilogue, C>(")):
        text = (csrc / name).read_text()
        assert '#include "mlp_mma_tile.cuh"' in text and "mlp_common.cuh\"" not in text
        assert call in text and "gemm_acc" not in text
    fma_users = {p.name for p in csrc.glob("*.cu*") if "forward_tile<float>(" in p.read_text()}
    assert fma_users == {"raymarch_fwd.cu"}


@pytest.mark.parametrize("probe", ["epilogue", "chains"])
def test_bf16_probes_reject_f32_weights_on_any_device(probe):
    _, tcfg, params, _, _, _, _ = _mlp_setup(8)
    ws32, bs32 = rc.flatten_params(tm.params_from_jax(params), tcfg, torch.float32)
    before = dict(kl.LAUNCHES)
    for dev in ("meta", "cpu"):
        x = torch.zeros((8, tcfg.xyz_dim), device=dev)
        d = torch.zeros((8, tcfg.dir_dim), device=dev)
        with pytest.raises(ValueError, match="bfloat16 only"):
            if probe == "epilogue":
                pk.mlp_fwd_variant(ws32, bs32, tcfg, x, d, "v1")
            else:
                pk.mlp_fwd_chains(ws32, bs32, tcfg, x, d, 2)
    assert kl.LAUNCHES == before


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


class _FakeLaunchLib:
    """P1's, P4-P6's and P7's C functions: launches that record their
    arguments and return ``rc``; P1's also reads the W pack it was given."""

    def __init__(self):
        self.calls, self.rc, self.packs = [], 0, []

    def nerf_probe_mma_unit_rows(self):
        return 64

    def nerf_probe_mma(self, *args):
        self.calls.append(("mma", args))
        self.packs.append(np.ctypeslib.as_array(
            (ctypes.c_uint16 * (256 * 256)).from_address(args[0])).copy())
        return self.rc

    def nerf_probe_expand_a(self, *args):
        self.calls.append(("expand_a", args))
        return self.rc

    def nerf_probe_expand_b(self, *args):
        self.calls.append(("expand_b", args))
        return self.rc

    def nerf_probe_expand_c(self, *args):
        self.calls.append(("expand_c", args))
        return self.rc

    def nerf_probe_enccost(self, *args):
        self.calls.append(("enccost", args))
        return self.rc


STREAM = 7  # the fake card's current stream


SMS = 132  # the fake card's SMs


@pytest.fixture
def fake_launch_card(monkeypatch):
    """The P1 / P4-P6 / P7 wrappers on CPU tensors as on the card: a fake
    library, SM count and stream; the launch counts are restored afterwards."""
    lib = _FakeLaunchLib()
    monkeypatch.setattr(pk, "uses_kernel", lambda t: True)
    monkeypatch.setattr(pk, "load", lambda name: lib)
    monkeypatch.setattr(pk, "stream_of", lambda dev: STREAM)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=SMS))
    counts = dict(kl.LAUNCHES)
    yield lib
    kl.LAUNCHES.update(counts)


def test_expand_a_wrapper_launches_once_a_call(fake_launch_card):
    zt = torch.randn(64, 64)
    before = kl.LAUNCHES["probe_expand_a"]
    out = pk.expand_a(zt)
    assert out.shape == (4096, 1) and out.dtype == torch.float32 and out.is_contiguous()
    assert fake_launch_card.calls == [("expand_a", (zt.data_ptr(), out.data_ptr(), 4096, STREAM))]
    assert kl.LAUNCHES["probe_expand_a"] == before + 1
    again = pk.expand_a(zt)
    assert fake_launch_card.calls[1] == ("expand_a", (zt.data_ptr(), again.data_ptr(), 4096,
                                                      STREAM))
    assert kl.LAUNCHES["probe_expand_a"] == before + 2


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "1d", "3d", "cuda_error"])
def test_expand_a_wrapper_raises_without_launching(fake_launch_card, bad):
    zt = {"float64": torch.zeros(64, 64, dtype=torch.float64),
          "non_contiguous": torch.zeros(64, 128)[:, ::2],
          "1d": torch.zeros(4096), "3d": torch.zeros(4, 64, 16),
          "cuda_error": torch.zeros(64, 64)}[bad]
    before = dict(kl.LAUNCHES)
    if bad == "cuda_error":
        fake_launch_card.rc = 700
        with pytest.raises(RuntimeError, match="probe_expand_a launch failed: CUDA error 700"):
            pk.expand_a(zt)
        assert len(fake_launch_card.calls) == 1
    else:
        with pytest.raises(ValueError, match="contiguous \\(S, R_t\\) float32"):
            pk.expand_a(zt)
        assert fake_launch_card.calls == []
    assert kl.LAUNCHES == before


def _expand_b_input(case):
    """P5's ``rd`` of a case: the tool's (64, 8), a width that is not a
    multiple of 4 (the kernel's scalar path), and a view one float into its
    storage (not 16-byte aligned: the scalar path too)."""
    return {"tool": torch.randn(64, 8), "x3": torch.randn(64, 3),
            "offset_view": torch.randn(64 * 8 + 1)[1:].view(64, 8)}[case]


@pytest.mark.parametrize("case", ["tool", "x3", "offset_view"])
def test_expand_b_wrapper_launches_once_a_call(fake_launch_card, case):
    rd, n_s = _expand_b_input(case), 64
    r_t, width = rd.shape
    before = kl.LAUNCHES["probe_expand_b"]
    out = pk.expand_b(rd, n_s)
    assert out.shape == (n_s * r_t, width) and out.dtype == torch.float32 and out.is_contiguous()
    assert fake_launch_card.calls == [
        ("expand_b", (rd.data_ptr(), out.data_ptr(), r_t, n_s, width, STREAM))]
    assert kl.LAUNCHES["probe_expand_b"] == before + 1
    again = pk.expand_b(rd, n_s)
    assert fake_launch_card.calls[1] == (
        "expand_b", (rd.data_ptr(), again.data_ptr(), r_t, n_s, width, STREAM))
    assert kl.LAUNCHES["probe_expand_b"] == before + 2


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "1d", "3d", "n_samples_0",
                                 "n_samples_negative", "cuda_error"])
def test_expand_b_wrapper_raises_without_launching(fake_launch_card, bad):
    rd = {"float64": torch.zeros(64, 8, dtype=torch.float64),
          "non_contiguous": torch.zeros(64, 16)[:, ::2],
          "1d": torch.zeros(512), "3d": torch.zeros(4, 16, 8)}.get(bad, torch.zeros(64, 8))
    n_s = {"n_samples_0": 0, "n_samples_negative": -1}.get(bad, 64)
    before = dict(kl.LAUNCHES)
    if bad == "cuda_error":
        fake_launch_card.rc = 700
        with pytest.raises(RuntimeError, match="probe_expand_b launch failed: CUDA error 700"):
            pk.expand_b(rd, n_s)
        assert len(fake_launch_card.calls) == 1
    else:
        with pytest.raises(ValueError, match="expected \\(R_t, X\\) and a positive sample count"):
            pk.expand_b(rd, n_s)
        assert fake_launch_card.calls == []
    assert kl.LAUNCHES == before


@pytest.mark.parametrize("shape", [(0, 8), (64, 0)])
def test_expand_b_wrapper_empty_input_launches_nothing(fake_launch_card, shape):
    before = dict(kl.LAUNCHES)
    out = pk.expand_b(torch.zeros(shape), 4)
    assert out.shape == (4 * shape[0], shape[1]) and out.dtype == torch.float32
    assert fake_launch_card.calls == [] and kl.LAUNCHES == before


@pytest.mark.parametrize("r_t,width,n_s", [(64, 8, 64), (64, 3, 64), (5, 1, 7), (1, 4, 3),
                                           (17, 3, 2)])
def test_expand_b_plain_matches_numpy(r_t, width, n_s):
    rd = np.random.default_rng(r_t * 100 + width).normal(size=(r_t, width)).astype(np.float32)
    got = pk.expand_b_plain(torch.tensor(rd), n_s)
    np.testing.assert_array_equal(got.numpy(), np.tile(rd, (n_s, 1)) * np.float32(2))


@pytest.fixture
def allocations(monkeypatch):
    """The shapes of the tensors ``torch.empty`` makes, in order."""
    shapes, real = [], torch.empty

    def empty(*args, **kwargs):
        t = real(*args, **kwargs)
        shapes.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", empty)
    return shapes


@pytest.mark.parametrize("m,depth,chains,steps", [(2048, 32, 1, 8), (512, 32, 4, 8),
                                                  (16, 4, 2, 1), (8192, 8, 1, 3)])
def test_mxu_chain_wrapper_passes_the_pack_and_unit_scratch(fake_launch_card, allocations, m,
                                                            depth, chains, steps):
    w = torch.tensor(np.random.default_rng(1).normal(size=(256, 256)).astype(np.float32)).to(
        torch.bfloat16)
    # The first pack of a process builds its cached index (an allocation of
    # its own): build it here, so the count is the call's whatever ran before.
    pk.mxu_pack(w)
    allocations.clear()
    before = kl.LAUNCHES["probe_mma"]
    out = pk.mxu_chain(w, m, depth, chains, steps)
    units = steps * -(-m // 64) * chains
    assert out.shape == (steps * 8, 256) and out.dtype == torch.float32
    assert allocations == [(units, 256), (steps * 8, 256)]
    ((name, args),) = fake_launch_card.calls
    assert name == "mma" and args[2] == out.data_ptr()
    assert args[3:] == (m, depth, chains, steps, min(units, SMS), STREAM)
    assert np.array_equal(fake_launch_card.packs[0],
                          pk.mxu_pack(w).view(torch.int16).numpy().view(np.uint16))
    assert kl.LAUNCHES["probe_mma"] == before + 1


@pytest.mark.parametrize("bad", ["m_24", "m_0", "chains_0", "float32", "shape", "non_contiguous",
                                 "cuda_error"])
def test_mxu_chain_wrapper_raises_without_launching(fake_launch_card, bad):
    w = torch.zeros((256, 256), dtype=torch.bfloat16)
    m, chains = {"m_24": (24, 1), "m_0": (0, 1), "chains_0": (64, 0)}.get(bad, (64, 1))
    w = {"float32": w.float(), "shape": torch.zeros((128, 256), dtype=torch.bfloat16),
         "non_contiguous": torch.zeros((256, 512), dtype=torch.bfloat16)[:, ::2]}.get(bad, w)
    before = dict(kl.LAUNCHES)
    if bad == "cuda_error":
        fake_launch_card.rc = 700
        with pytest.raises(RuntimeError, match="probe_mma launch failed: CUDA error 700"):
            pk.mxu_chain(w, m, 4, chains)
        assert len(fake_launch_card.calls) == 1
    else:
        with pytest.raises(ValueError):
            pk.mxu_chain(w, m, 4, chains)
        assert fake_launch_card.calls == []
    assert kl.LAUNCHES == before


def _expand_c_inputs(n_tiles=2, r_t=8, n_s=4, n_theta=10, n_enc=33):
    rng = np.random.default_rng(2)
    f = lambda *shape: torch.tensor(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    return (f(n_tiles * n_s, r_t), f(n_tiles * n_s, r_t), f(n_tiles * n_s, r_t),
            f(n_tiles * r_t, 3), f(6, n_theta), f(n_theta, n_enc))


def test_expand_c_wrapper_passes_its_pointers_and_shapes(fake_launch_card):
    ins = _expand_c_inputs()
    before = kl.LAUNCHES["probe_expand_c"]
    out = pk.expand_c(*ins)
    assert out.shape == (64, 33) and out.dtype == torch.float32 and out.is_contiguous()
    assert fake_launch_card.calls == [("expand_c", (
        *(t.data_ptr() for t in ins), out.data_ptr(), 2, 8, 4, 10, 33, STREAM))]
    assert kl.LAUNCHES["probe_expand_c"] == before + 1


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "vc_shape", "sc_shape",
                                 "too_many_columns", "cuda_error"])
def test_expand_c_wrapper_raises_without_launching(fake_launch_card, bad):
    px, py, pz, vc, sc, gx = _expand_c_inputs(n_enc=34 if bad == "too_many_columns" else 33)
    if bad == "float64":
        py = py.double()
    elif bad == "non_contiguous":
        pz = torch.zeros((8, 16))[:, ::2]
    elif bad == "vc_shape":
        vc = torch.zeros((16, 4))
    elif bad == "sc_shape":
        sc = torch.zeros((5, 10))
    before = dict(kl.LAUNCHES)
    if bad == "cuda_error":
        fake_launch_card.rc = 1
        with pytest.raises(RuntimeError, match="probe_expand_c launch failed: CUDA error 1"):
            pk.expand_c(px, py, pz, vc, sc, gx)
        assert len(fake_launch_card.calls) == 1
    else:
        with pytest.raises(ValueError):
            pk.expand_c(px, py, pz, vc, sc, gx)
        assert fake_launch_card.calls == []
    assert kl.LAUNCHES == before


@pytest.mark.parametrize("stage", pk.ENC_STAGES)
def test_enc_cost_wrapper_passes_its_arguments_and_stage_index(fake_launch_card, stage):
    cfg = tm.MLPConfig()
    rd, z = torch.randn(16, 9), 2.0 + torch.rand(16, 8)
    before = kl.LAUNCHES["probe_enccost"]
    out = pk.enc_cost(rd, z, stage, cfg, r_t=8)
    assert out.shape == (128, 4) and out.dtype == torch.float32
    index = {"dma": 0, "repeat": 1, "pts": 2, "theta": 3, "sin": 4, "enc": 5}[stage]
    assert fake_launch_card.calls == [("enccost", (
        index, rd.data_ptr(), z.data_ptr(), out.data_ptr(), 16, 8, cfg.n_freq_xyz,
        cfg.n_freq_dir, cfg.n_angles + 1, 8, STREAM))]
    assert kl.LAUNCHES["probe_enccost"] == before + 1


@pytest.mark.parametrize("bad", ["rd_float64", "z_float64", "rd_non_contiguous",
                                 "z_non_contiguous", "rd_1d", "z_1d", "rd_3d", "z_3d",
                                 "cuda_error"])
def test_enc_cost_wrapper_raises_without_launching(fake_launch_card, bad):
    rd, z = torch.randn(16, 9), 2.0 + torch.rand(16, 8)
    rd, z = {"rd_float64": (rd.double(), z), "z_float64": (rd, z.double()),
             "rd_non_contiguous": (torch.randn(16, 18)[:, ::2], z),
             "z_non_contiguous": (rd, torch.rand(16, 16)[:, ::2]),
             "rd_1d": (rd.reshape(-1), z), "z_1d": (rd, z.reshape(-1)),
             "rd_3d": (rd[None], z), "z_3d": (rd, z[..., None])}.get(bad, (rd, z))
    before = dict(kl.LAUNCHES)
    if bad == "cuda_error":
        fake_launch_card.rc = 1
        with pytest.raises(RuntimeError, match="probe_enccost launch failed: CUDA error 1"):
            pk.enc_cost(rd, z, "enc", r_t=8)
        assert len(fake_launch_card.calls) == 1
    else:
        with pytest.raises(ValueError):
            pk.enc_cost(rd, z, "enc", r_t=8)
        assert fake_launch_card.calls == []
    assert kl.LAUNCHES == before


def test_stream_of_reads_the_current_streams_raw_handle(monkeypatch):
    seen = []
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: seen.append(index) or 1000 + index, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert kl.stream_of(torch.device("cuda", 1)) == 1001
    assert kl.stream_of(torch.device("cuda")) == 1003
    assert seen == [1, 3]


def test_enc_cost_probe_runs_b6s_input_build_at_b6s_geometry():
    """P7 builds its stages with bf16 B6's input build (``build_mma_inputs``, its
    default stage B6's own call) in B6's block and forward shared memory; the
    stage enum lives with that cut, in the C interface's order, and the FMA
    tile's ``build_inputs`` has no stage left."""
    csrc = ROOT / "nerf_and_dietnerf_tpu_torch" / "csrc"
    src = (csrc / "probe_enccost.cu").read_text()
    tile = (csrc / "raymarch_tile.cuh").read_text()
    common = (csrc / "raymarch_common.cuh").read_text()
    fwd = (csrc / "raymarch_fwd.cu").read_text()
    assert '#include "raymarch_tile.cuh"' in src
    for line in ("    build_mma_inputs(ry, xyz, dir, row0, n, t.X, t.D);",
                 "    build_mma_inputs<STAGE>(ry, xyz, dir, row0, n, X, D);",
                 "  const nerf_mma::Tiles t = nerf_mma::make_tiles(smem16, false);",
                 "__global__ void __launch_bounds__(nerf_mma::NT, 1)",
                 "  return (int)launch_kernel(enc_cost_kernel<STAGE>, tiles, nerf_mma::NT,",
                 "                            nerf_mma::fwd_smem_bytes(), stream, ry, xyz, dir, "
                 "r_t, out);",
                 "constexpr int ENC_DMA = 0;  // before the stages of build_mma_inputs (EncStage)"):
        assert line in src, line
    assert "  build_mma_inputs(ry, dm.xyz, dm.dir, row0, dm.n, t.X, t.D);" in fwd
    assert ("launch_kernel(rm_fwd_mma_kernel, tiles, nerf_mma::NT, nerf_mma::fwd_smem_bytes(),"
            in fwd)
    assert "enum EncStage { ENC_REPEAT = 1, ENC_PTS, ENC_THETA, ENC_SIN, ENC_FULL };" in tile
    assert "template <int STAGE = ENC_FULL, typename T = nerf_mma::bf16>" in tile
    assert "EncStage" not in common and "STAGE" not in common
    assert "template <typename T>\n__device__ void build_inputs(" in common
    cases = [line.split()[1].rstrip(":") for line in src.splitlines()
             if line.strip().startswith("case ENC_")]
    stages = ["ENC_DMA", "ENC_REPEAT", "ENC_PTS", "ENC_THETA", "ENC_SIN", "ENC_FULL"]
    assert cases == stages and len(pk.ENC_STAGES) == len(stages)


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
