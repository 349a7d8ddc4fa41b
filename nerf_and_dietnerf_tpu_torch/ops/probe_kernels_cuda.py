"""The probe kernels P1-P7 and their wrappers.

Port of the seven Pallas probes of the JAX package's ``tools/exp_mxu.py``
(P1), ``tools/exp_vpu.py`` (P2), ``tools/exp_interleave.py`` (P3),
``tools/exp_expand.py`` (P4, P5, P6) and ``tools/exp_enccost.py`` (P7). Each
is a CUDA C++ kernel for ``sm_90a`` in ``csrc/probe_*.cu``, built and loaded
by ``ops/kernel_lib.py``; the tools in ``nerf_and_dietnerf_tpu_torch/tools``
time them on the card.

Beside each wrapper is its plain PyTorch version, which computes what the TPU
probe computes. A wrapper takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from nerf_and_dietnerf_tpu_torch.models.mlp import N_TRUNK_LAYERS, SKIP_AFTER, MLPConfig
from nerf_and_dietnerf_tpu_torch.ops.kernel_lib import (
    check_tensors,
    flat,
    launched,
    load,
    stream_of,
    uses_kernel,
)
from nerf_and_dietnerf_tpu_torch.ops.raymarch_cuda import _weights_for, check_params, mlp_fwd_plain

MXU_WIDTH = 256                      # P1: columns of h, rows and columns of W
MLP_VARIANTS = {"v1": 1, "v5": 5, "v3": 3}
ENC_STAGES = ("dma", "repeat", "pts", "theta", "sin", "enc")
MAX_SHARED_BYTES = 232448            # what one block can use on an H100
REGISTERS_PER_SM = 65536             # 32-bit registers of an H100 SM
_BF16 = torch.bfloat16


def _bf(t: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16, held in f32."""
    return t.to(_BF16).float()


def tensors_from_jax(arrays: Dict[str, object], device="cpu", bf16=()) -> Dict[str, torch.Tensor]:
    """The JAX probes' constants and inputs (numpy or jax arrays: ``w`` of P1,
    ``sc`` / ``gx`` of P6, ``masks`` / ``offs`` / ``F2`` of P7, ...) as the
    port's contiguous f32 tensors on ``device``; names in ``bf16`` become
    bf16 tensors (exact for arrays that already hold bf16 values)."""
    out = {}
    for name, a in arrays.items():
        t = torch.tensor(np.asarray(a).astype(np.float32), device=device)
        out[name] = (t.to(_BF16) if name in bf16 else t).contiguous()
    return out


# --------------------------------------------------------------------------- #
# P1: chain of 256-wide bf16 products on the tensor cores                      #
# --------------------------------------------------------------------------- #

def mxu_chain_plain(w: torch.Tensor, m: int, depth: int, n_chains: int,
                    steps: int = 8) -> torch.Tensor:
    """Plain version of P1: ``(steps * 8, 256)`` f32. Per step and chain c,
    ``h = bf16(col * 0.001 (c + 1))`` in all ``m`` rows, ``depth // n_chains``
    times ``h <- bf16(bf16(h @ w, f32 sums) * bf16(0.01))``; the column sums
    over the rows of the chains' f32 sum, in 8 equal rows per step."""
    wf = w.float()
    s = _bf(torch.tensor(0.01, device=w.device))
    col = torch.arange(MXU_WIDTH, dtype=torch.float32, device=w.device)
    acc = None
    for c in range(n_chains):
        h = _bf(col * float(np.float32(0.001 * (c + 1)))).expand(m, MXU_WIDTH)
        for _ in range(depth // n_chains):
            h = _bf(_bf(h @ wf) * s)
        acc = h if acc is None else acc + h
    row = acc.sum(dim=0, keepdim=True)
    return row.expand(steps * 8, MXU_WIDTH).contiguous()


def kmajor_offset(n, k, np_: int):
    """Element offset of entry ``(n, k)`` of an ``np_``-row W^T in the bf16
    ``wgmma`` B layout (``kmajor_offset`` of ``csrc/wgmma_bf16.cuh``; ``n``,
    ``k`` ints or integer tensors): k-steps of 16 columns, ``np_ x 16`` each,
    as core matrices of 8 rows x 8 columns (128 contiguous bytes), the two of
    an 8-row group side by side, the groups 256 bytes apart."""
    return ((k // 16) * np_ * 16 + (n // 8) * 128 + ((k % 16) // 8) * 64 + (n % 8) * 8
            + k % 8)


@functools.lru_cache(maxsize=None)
def _mxu_pack_index(device) -> torch.Tensor:
    """Index of each entry of P1's W pack in ``w.reshape(-1)``, on ``device``."""
    n, k = torch.meshgrid(torch.arange(MXU_WIDTH), torch.arange(MXU_WIDTH), indexing="ij")
    idx = torch.empty(MXU_WIDTH * MXU_WIDTH, dtype=torch.long)
    idx[kmajor_offset(n, k, MXU_WIDTH).reshape(-1)] = (k * MXU_WIDTH + n).reshape(-1)
    return idx.to(device)


def mxu_pack(w: torch.Tensor) -> torch.Tensor:
    """P1's ``w`` (256, 256) as the kernel's bulk copies read it: W^T in the
    layout of :func:`kmajor_offset`, flat, one gather through a cached index."""
    return torch.index_select(w.reshape(-1), 0, _mxu_pack_index(w.device))


def mxu_chain(w: torch.Tensor, m: int, depth: int, n_chains: int, steps: int = 8) -> torch.Tensor:
    """P1: the chain of :func:`mxu_chain_plain` as bf16 ``wgmma`` products, a
    warpgroup a unit of 64 rows of one chain, ``w`` (256, 256) bf16 held in
    shared memory (:func:`mxu_pack`'s layout). ``m`` is a multiple of 16. The
    result is bitwise reproducible."""
    if m <= 0 or m % 16 or depth < 0 or n_chains <= 0 or steps <= 0:
        raise ValueError(f"need m a positive multiple of 16, n_chains and steps positive; got "
                         f"m={m} depth={depth} n_chains={n_chains} steps={steps}")
    if not uses_kernel(w):
        return mxu_chain_plain(w, m, depth, n_chains, steps)
    dev = w.device
    check_tensors([(w, (MXU_WIDTH, MXU_WIDTH), _BF16)], dev)
    lib = load("probe_mma")
    units = steps * -(-m // lib.nerf_probe_mma_unit_rows()) * n_chains
    n_blocks = min(units, torch.cuda.get_device_properties(dev).multi_processor_count)
    pack = mxu_pack(w)  # held until queued
    partial = torch.empty((units, MXU_WIDTH), dtype=torch.float32, device=dev)
    out = torch.empty((steps * 8, MXU_WIDTH), dtype=torch.float32, device=dev)
    rc = lib.nerf_probe_mma(pack.data_ptr(), partial.data_ptr(), out.data_ptr(), m, depth,
                            n_chains, steps, n_blocks, stream_of(dev))
    launched("probe_mma", rc)
    return out


# --------------------------------------------------------------------------- #
# P2: B1 with another epilogue                                                 #
# --------------------------------------------------------------------------- #

def _check_view_mlp(config: MLPConfig, what: str) -> None:
    if not config.uses_view_dirs:
        raise ValueError(f"{what} runs the view-dir variant of the MLP only")


def _check_bf16_weights(ws, what: str) -> None:
    """P2 and P3 are bf16 probes (the TPU tools' ``CD``), on every device."""
    if any(w.dtype != _BF16 for w in ws):
        raise ValueError(f"{what} runs in bfloat16 only; got weights of "
                         f"{sorted({str(w.dtype) for w in ws})}")


def mlp_fwd_variant_plain(ws, bs, config: MLPConfig, x, d, variant: str) -> torch.Tensor:
    """Plain version of P2: the view-dir MLP in bf16 (``ws`` bf16, ``bs`` f32
    from ``flatten_params``) with the hidden layers' epilogue ``variant``:
    ``v1`` bf16(p); ``v5`` bias and max-form leaky in bf16; ``v3`` f32 bias and
    max-form leaky, then bf16. The output heads keep their f32 bias."""
    _check_view_mlp(config, "the epilogue probe")
    alpha = config.leaky_relu_alpha
    if variant == "v1":
        act = lambda p, b: _bf(p)  # noqa: E731
    elif variant == "v5":
        a16 = _bf(torch.tensor(alpha, device=x.device))

        def act(p, b):
            q = _bf(_bf(p) + _bf(b))
            return torch.maximum(q, _bf(a16 * q))
    elif variant == "v3":
        def act(p, b):
            p = p + b
            return _bf(torch.maximum(p, alpha * p))
    else:
        raise ValueError(f"variant must be one of {sorted(MLP_VARIANTS)}, got {variant!r}")
    W = [w.float() for w in ws]
    xf, df = _bf(x.float()), _bf(d.float())
    h = xf
    wi = 0
    for layer in range(N_TRUNK_LAYERS):
        if layer == SKIP_AFTER:
            pre = xf @ W[wi] + h @ W[wi + 1]
            wi += 2
        else:
            pre = h @ W[wi]
            wi += 1
        h = act(pre, bs[layer])
    b = N_TRUNK_LAYERS
    rgb_h = act(h @ W[wi] + df @ W[wi + 1], bs[b])
    rgb = rgb_h @ W[wi + 2] + bs[b + 1]
    sigma = h @ W[wi + 3] + df @ W[wi + 4] + bs[b + 2]
    return torch.cat([rgb, sigma], dim=-1)


def _check_mlp_probe(config: MLPConfig, ws, bs, x, d, in_dtype, cd) -> None:
    """``x`` / ``d`` of ``in_dtype`` and the parameters of compute type ``cd``
    against the config: nothing is cast or copied on the way to the kernel."""
    n = x.shape[0]
    check_tensors([(x, (n, config.xyz_dim), in_dtype), (d, (n, config.dir_dim), in_dtype)],
                  x.device)
    check_params(config, ws, bs, cd, x.device)


def _mlp_tail(config: MLPConfig, n: int, dev):
    """n, xyz, dir, hid, last, alpha, stream of the MLP probes."""
    return (n, config.xyz_dim, config.dir_dim, config.hidden_dim, config.last_hidden_dim,
            config.leaky_relu_alpha, stream_of(dev))


def mlp_fwd_variant(ws, bs, config: MLPConfig, x, d, variant: str) -> torch.Tensor:
    """P2: ``(n, 4)`` f32 from bf16 B1's tensor-core tile with the epilogue
    ``variant`` (see :func:`mlp_fwd_variant_plain`; ``v3`` is B1's function,
    and on the card B1's output bitwise). ``ws`` bf16, ``bs`` f32; ``x`` (n,
    xyz) and ``d`` (n, dir) are f32, and the kernel rounds them to bf16 as it
    loads a tile, as the TPU probe rounds them in its body."""
    _check_bf16_weights(ws, "the epilogue probe")
    if not uses_kernel(x):
        return mlp_fwd_variant_plain(ws, bs, config, x, d, variant)
    _check_view_mlp(config, "the epilogue probe")
    if variant not in MLP_VARIANTS:
        raise ValueError(f"variant must be one of {sorted(MLP_VARIANTS)}, got {variant!r}")
    _check_mlp_probe(config, ws, bs, x, d, torch.float32, _BF16)
    n = x.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = load("probe_mlp_epilogue")
    (w,), b = _weights_for(lib, ws, config, _BF16, ("f",)), flat(bs)  # held until queued
    rc = lib.nerf_probe_mlp_epilogue(
        MLP_VARIANTS[variant], x.data_ptr(), d.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), *_mlp_tail(config, n, x.device))
    launched("probe_mlp_epilogue", rc)
    return out


# --------------------------------------------------------------------------- #
# P3: B1 with several row chains per block                                     #
# --------------------------------------------------------------------------- #

class SharedMemoryExceeded(ValueError):
    """The launch would need more shared memory than a block can have."""


# The chains' tile (csrc/mlp_mma_tile.cuh at WM = n_chains row halves): each
# 64-row chain holds P (LDH = 264 bf16 a row), X (LDX = 72), D (LDD = 40) and
# a float of sigma a row; the block one ring of NSTAGE = 2 stages of HPAD =
# 256 rows x LDW = 40 bf16. A chain is 4 warps, each thread of it doing B1's
# work whatever the chain count.
CHAIN_ROWS = 64
_CHAIN_ROW_BYTES = 2 * (264 + 72 + 40) + 4
_RING_BYTES = 2 * 2 * 256 * 40
_CHAIN_THREADS = 128


def chains_smem_bytes(n_chains: int) -> int:
    """Shared memory of a block of ``n_chains`` chains, as the kernel's
    ``nerf_probe_chains_smem`` computes it (``fwd_smem_bytes<C>``)."""
    return n_chains * CHAIN_ROWS * _CHAIN_ROW_BYTES + _RING_BYTES


def chains_limits(n_chains: int, registers: Optional[int] = None) -> List[str]:
    """The block limits a tile of ``n_chains`` chains exceeds, one line each
    (empty if it fits): its shared memory and, where ``registers`` is given
    (what ``-Xptxas -v`` reports for a thread of a chain count that was
    built), the registers of its threads against an SM's file (at most 255
    a thread)."""
    out = []
    need = chains_smem_bytes(n_chains)
    if need > MAX_SHARED_BYTES:
        out.append(f"{need} bytes of shared memory; a block may use {MAX_SHARED_BYTES}")
    threads = n_chains * _CHAIN_THREADS
    have = min(255, REGISTERS_PER_SM // threads)
    if registers is not None and registers > have:
        out.append(f"{threads} threads of {registers} registers; an SM's {REGISTERS_PER_SM} "
                   f"registers give each {have}")
    return out


def mlp_fwd_chains(ws, bs, config: MLPConfig, x, d, n_chains: int) -> torch.Tensor:
    """P3: bf16 B1's ``(n, 4)`` f32 output (its plain version is B1's,
    :func:`mlp_fwd_plain`) from blocks of ``n_chains`` 64-row chains that share
    every streamed weight chunk (on the card bitwise B1's for every count that
    runs). ``ws`` bf16, ``bs`` f32; on the card ``x`` and ``d`` come in bf16.
    There a chain count whose tile needs more shared memory than a block
    has (:func:`chains_limits`: 4) raises :class:`SharedMemoryExceeded`
    before any launch."""
    if n_chains not in (1, 2, 4):
        raise ValueError(f"n_chains must be 1, 2 or 4, got {n_chains}")
    _check_bf16_weights(ws, "the chains probe")
    if not uses_kernel(x):
        return mlp_fwd_plain(ws, bs, config, x.to(_BF16), d.to(_BF16), _BF16)
    _check_view_mlp(config, "the chains probe")
    _check_mlp_probe(config, ws, bs, x, d, _BF16, _BF16)
    lib = load("probe_mlp_chains")
    need = lib.nerf_probe_chains_smem(n_chains)
    if need != chains_smem_bytes(n_chains):
        raise RuntimeError(f"kernel ({need}) and wrapper ({chains_smem_bytes(n_chains)}) "
                           f"disagree on the shared memory of {n_chains} chains")
    over = chains_limits(n_chains)
    if over:
        raise SharedMemoryExceeded(f"{n_chains} chains of {CHAIN_ROWS} rows need "
                                   + " and ".join(over))
    n = x.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    (w,), b = _weights_for(lib, ws, config, _BF16, ("f",)), flat(bs)  # held until queued
    rc = lib.nerf_probe_mlp_chains(
        n_chains, x.data_ptr(), d.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        *_mlp_tail(config, n, x.device))
    launched("probe_mlp_chains", rc)
    return out


# --------------------------------------------------------------------------- #
# P4, P5, P6: per-ray data to sample-major rows                                #
# --------------------------------------------------------------------------- #

def expand_a_plain(zt: torch.Tensor) -> torch.Tensor:
    """Plain version of P4: ``zt`` (S, R_t) -> ``(S R_t, 1)``,
    ``out[s R_t + r] = zt[s, r] + 1``."""
    return zt.reshape(-1, 1) + 1.0


def expand_a(zt: torch.Tensor) -> torch.Tensor:
    """P4 (see :func:`expand_a_plain`). Its work is a launch's worth, so its
    time is the host's, and the path to the launch is kept lean: one inline
    check of the tensor and ``new_empty`` for the output, the C function as
    ``load`` bound it, the current stream read as its raw handle
    (:func:`kernel_lib.stream_of`)."""
    if not uses_kernel(zt):
        return expand_a_plain(zt)
    if zt.dtype != torch.float32 or zt.dim() != 2 or not zt.is_contiguous():
        raise ValueError(f"expected a contiguous (S, R_t) float32 tensor, got "
                         f"{tuple(zt.shape)} {zt.dtype}, contiguous {zt.is_contiguous()}")
    n = zt.numel()
    out = zt.new_empty((n, 1))
    rc = load("probe_expand").nerf_probe_expand_a(zt.data_ptr(), out.data_ptr(), n,
                                                  stream_of(zt.device))
    launched("probe_expand_a", rc)
    return out


def expand_b_plain(rd: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Plain version of P5: ``rd`` (R_t, X) -> ``(S R_t, X)``,
    ``out[s R_t + r] = 2 rd[r]``."""
    return rd.repeat(n_samples, 1) * 2.0


def expand_b(rd: torch.Tensor, n_samples: int) -> torch.Tensor:
    """P5 (see :func:`expand_b_plain`). Like P4 a launch's worth of work on
    P4's lean launch path (:func:`expand_a`); an empty ``rd`` gives an empty
    output without a launch."""
    if not uses_kernel(rd):
        return expand_b_plain(rd, n_samples)
    if rd.dtype != torch.float32 or rd.dim() != 2 or not rd.is_contiguous() or n_samples <= 0:
        raise ValueError(f"expected (R_t, X) and a positive sample count, got {tuple(rd.shape)}, "
                         f"{n_samples} ({rd.dtype}, contiguous {rd.is_contiguous()}; the "
                         f"kernel takes contiguous float32)")
    r_t, width = rd.shape
    out = rd.new_empty((n_samples * r_t, width))
    if r_t == 0 or width == 0:
        return out
    rc = load("probe_expand").nerf_probe_expand_b(rd.data_ptr(), out.data_ptr(), r_t, n_samples,
                                                  width, stream_of(rd.device))
    launched("probe_expand_b", rc)
    return out


EXPAND_C_MAX_E = 33  # P6's register sums a row: the TPU probe's encode width (MAX_E)


def _expand_c_shapes(px, vc, sc, gx):
    """``(n_tiles, R_t, S, T, E)`` of P6's inputs."""
    r_t = px.shape[1]
    if vc.shape[0] % r_t or px.shape[0] % max(vc.shape[0] // r_t, 1):
        raise ValueError(f"px {tuple(px.shape)} and vc {tuple(vc.shape)} are not whole tiles")
    n_tiles = vc.shape[0] // r_t
    return n_tiles, r_t, px.shape[0] // n_tiles, sc.shape[1], gx.shape[1]


def expand_c_plain(px, py, pz, vc, sc, gx) -> torch.Tensor:
    """Plain version of P6. Per tile of R_t rays: points from the (S, R_t)
    blocks of ``px``, ``py``, ``pz`` (n_tiles S, R_t), the tile's view
    components ``vc`` (n_tiles R_t, 3) repeated for every sample, ``theta =
    [pts | vc] @ sc`` (6, T), ``enc = sin(theta) @ gx`` (T, E), all f32:
    ``(n_tiles S R_t, E)``, row = (tile S + s) R_t + r."""
    n_tiles, r_t, n_s, _, _ = _expand_c_shapes(px, vc, sc, gx)
    pts = torch.stack([p.reshape(n_tiles, n_s * r_t) for p in (px, py, pz)], dim=-1)
    vcr = vc.reshape(n_tiles, 1, r_t, 3).expand(n_tiles, n_s, r_t, 3).reshape(
        n_tiles, n_s * r_t, 3)
    u = torch.cat([pts, vcr], dim=-1).reshape(-1, 6)
    return torch.sin(u @ sc) @ gx


def expand_c(px, py, pz, vc, sc, gx) -> torch.Tensor:
    """P6 (see :func:`expand_c_plain`): a thread a row, theta, its sine and
    the row's ``E`` sums in registers (``E`` at most
    :data:`EXPAND_C_MAX_E`), each output one f32 chain in ascending angle
    column. Its device time is tens of µs, so the path to the launch is P4's
    lean one: the checks inline, ``new_empty`` for the output."""
    if not uses_kernel(px):
        return expand_c_plain(px, py, pz, vc, sc, gx)
    n_tiles, r_t, n_s, n_theta, n_enc = _expand_c_shapes(px, vc, sc, gx)
    if n_enc > EXPAND_C_MAX_E:
        raise ValueError(f"P6's kernel holds at most {EXPAND_C_MAX_E} output columns, got {n_enc}")
    dev = px.device
    for t, shape in ((px, (n_tiles * n_s, r_t)), (py, px.shape), (pz, px.shape),
                     (vc, (n_tiles * r_t, 3)), (sc, (6, n_theta)), (gx, (n_theta, n_enc))):
        if t.shape != shape or t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"expected a contiguous {tuple(shape)} float32 tensor on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}, contiguous "
                             f"{t.is_contiguous()}")
    out = px.new_empty((n_tiles * n_s * r_t, n_enc))
    if out.numel() == 0:
        return out
    rc = load("probe_expand").nerf_probe_expand_c(
        px.data_ptr(), py.data_ptr(), pz.data_ptr(), vc.data_ptr(), sc.data_ptr(), gx.data_ptr(),
        out.data_ptr(), n_tiles, r_t, n_s, n_theta, n_enc, stream_of(px.device))
    launched("probe_expand_c", rc)
    return out


# --------------------------------------------------------------------------- #
# P7: bf16 B6's in-kernel encode, cut off stage by stage                       #
# --------------------------------------------------------------------------- #

def enc_layout(config: MLPConfig) -> Dict[str, object]:
    """The TPU ray-march kernels' angle layout (the port's own copy of the JAX
    package's ``research_kernels._enc_layout``): ``T = 2 (nx + nd)`` columns
    ``[xyz-sin (nx) | xyz-cos (nx) | dir-sin (nd) | dir-cos (nd)]``, coordinate
    major (column ``c L + k``), with ``masks`` (3 + D, T) holding ``pi 2^k`` in
    the row of the column's coordinate and ``offs`` (1, T) the cos columns'
    ``pi / 2``."""
    L, Ld, D = config.n_freq_xyz, config.n_freq_dir, config.n_angles + 1
    nx, nd = 3 * L, D * Ld
    T = 2 * (nx + nd)
    masks = np.zeros((3 + D, T), np.float32)
    offs = np.zeros((1, T), np.float32)
    for c in range(3):
        for k in range(L):
            f = math.pi * 2.0 ** k
            masks[c, c * L + k] = masks[c, nx + c * L + k] = f
            offs[0, nx + c * L + k] = math.pi / 2.0
    for c in range(D):
        for k in range(Ld):
            f = math.pi * 2.0 ** k
            masks[3 + c, 2 * nx + c * Ld + k] = masks[3 + c, 2 * nx + nd + c * Ld + k] = f
            offs[0, 2 * nx + nd + c * Ld + k] = math.pi / 2.0
    return {"masks": masks, "offs": offs, "T": T, "nx": nx, "nd": nd, "D": D}


def expand_f2(r_t: int, n_samples: int) -> np.ndarray:
    """The one-hot sample picker of the TPU kernels (``_expand_consts``):
    ``F2[row, s] = (row // r_t == s)``, (r_t S, S) f32."""
    rows = np.arange(r_t * n_samples)
    return (rows[:, None] // r_t == np.arange(n_samples)[None, :]).astype(np.float32)


def _check_enc_cost(config: MLPConfig, rd, z, stage: str, r_t: int) -> None:
    _check_view_mlp(config, "the encode-cost probe")
    if stage not in ENC_STAGES:
        raise ValueError(f"stage must be one of {ENC_STAGES}, got {stage!r}")
    if rd.dim() != 2 or z.dim() != 2:
        raise ValueError(f"expected rays (R, {7 + config.n_angles}) and z (R, S), got "
                         f"{tuple(rd.shape)}, {tuple(z.shape)}")
    n_rays, n_s = z.shape
    if rd.shape != (n_rays, 6 + config.n_angles + 1) or n_rays % r_t or n_s < 4 \
            or config.n_freq_xyz < 2:
        raise ValueError(f"expected rays ({n_rays}, {7 + config.n_angles}) in whole tiles of "
                         f"{r_t}, at least 4 samples and 2 xyz octaves; got {tuple(rd.shape)}, "
                         f"{tuple(z.shape)}")


def enc_cost_plain(rd, z, stage: str, config: Optional[MLPConfig] = None, r_t: int = 64,
                   consts: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Plain version of P7: the TPU probe's arithmetic on tiles of ``r_t``
    rays, rows sample-major inside a tile; ``(R S, 4)`` f32, the summary of
    ``stage`` (see :data:`ENC_STAGES` and ``csrc/probe_enccost.cu``).
    ``consts`` may bring ``masks``, ``offs`` and ``F2`` (else the port's own
    :func:`enc_layout` / :func:`expand_f2`)."""
    config = config or MLPConfig()
    _check_enc_cost(config, rd, z, stage, r_t)
    lay = enc_layout(config)
    n_rays, n_s = z.shape
    rows = r_t * n_s
    if consts is None:
        consts = tensors_from_jax({"masks": lay["masks"], "offs": lay["offs"],
                                   "F2": expand_f2(r_t, n_s)}, rd.device)
    masks, offs, f2 = consts["masks"], consts["offs"], consts["F2"]
    out = []
    for tile in range(n_rays // r_t):
        rdt, zt = rd[tile * r_t:(tile + 1) * r_t], z[tile * r_t:(tile + 1) * r_t]
        if stage == "dma":
            out.append((torch.zeros((rows, 4), device=rd.device) + rdt[0, 0]) + zt[0, 0])
            continue
        rdr, zr = rdt.repeat(n_s, 1), zt.repeat(n_s, 1)
        if stage == "repeat":
            out.append(rdr[:, 0:4] + zr[:, 0:4])
            continue
        z_row = (zr * f2).sum(dim=1, keepdim=True)
        pts = rdr[:, 0:3] + z_row * rdr[:, 3:6]
        if stage == "pts":
            out.append(torch.cat([pts, z_row], dim=1))
            continue
        theta = offs.expand(rows, offs.shape[1])
        for c in range(3):
            theta = theta + pts[:, c:c + 1] * masks[c:c + 1]
        for c in range(lay["D"]):
            theta = theta + rdr[:, 6 + c:7 + c] * masks[3 + c:4 + c]
        if stage == "theta":
            out.append(theta[:, 0:4])
            continue
        sc = torch.sin(theta)
        if stage == "sin":
            out.append(sc[:, 0:4])
            continue
        enc = _bf(torch.cat([pts, sc[:, :2 * lay["nx"]]], dim=1))
        encd = _bf(sc[:, 2 * lay["nx"]:])
        out.append((torch.zeros((rows, 4), device=rd.device) + enc[:, 0:1]) + encd[:, 0:1])
    return torch.cat(out, dim=0).contiguous()


def enc_cost(rd, z, stage: str, config: Optional[MLPConfig] = None,
             r_t: int = 64) -> torch.Tensor:
    """P7: bf16 B6's input stage (``build_mma_inputs`` of
    ``csrc/raymarch_tile.cuh``, at B6's block and shared memory) cut off after
    ``stage``, with the stage's ``(R S, 4)`` summary in the TPU probe's row
    order (see :func:`enc_cost_plain`); each stage does the work of the one
    before it. ``rd`` (R, 6 + D) f32 rays, ``z`` (R, S) f32."""
    config = config or MLPConfig()
    if not uses_kernel(rd):
        return enc_cost_plain(rd, z, stage, config, r_t)
    _check_enc_cost(config, rd, z, stage, r_t)
    n_rays, n_s = z.shape
    check_tensors([(rd, rd.shape, torch.float32), (z, z.shape, torch.float32)], rd.device)
    if n_rays * n_s >= 2 ** 31:
        raise ValueError(f"{n_rays} x {n_s} rows exceed the kernel's 32-bit row index")
    out = torch.empty((n_rays * n_s, 4), dtype=torch.float32, device=rd.device)
    if out.numel() == 0:
        return out
    rc = load("probe_enccost").nerf_probe_enccost(
        ENC_STAGES.index(stage), rd.data_ptr(), z.data_ptr(), out.data_ptr(), n_rays, n_s,
        config.n_freq_xyz, config.n_freq_dir, config.n_angles + 1, r_t, stream_of(rd.device))
    launched("probe_enccost", rc)
    return out
