"""The fused radiance-MLP kernels (forward B1, backward B2) and their wrappers.

Port of ``nerf_and_dietnerf_tpu/ops/raymarch_pallas.py`` (``_forward_pallas``,
``_backward_pallas``, the custom VJP ``_fused_mlp`` / ``apply_mlp_fused``).
The kernels are CUDA C++ for ``sm_90a`` in ``csrc/``, built with ``nvcc`` at
first use and loaded by ``ops/kernel_lib.py``. This module also holds the
flat parameter layout and the plain MLP versions that the fused ray-march
kernels of ``ops/research_kernels_cuda.py`` reuse.

In bf16 both kernels run their products on the tensor cores and read the
weights from two packs that :func:`pack_mma_weights` builds once per call
(``csrc/mlp_mma_tile.cuh``). In f32, B1 runs 3xTF32 products on the tensor
cores and reads the hi / lo weight packs of :func:`tf32_weights`
(``csrc/mlp_tf32_tile.cuh``); f32 B2, like the f32 backwards of B7 and
B5 (``ops/research_kernels_cuda``), runs 3xTF32 on ``mma.sync`` and reads
the F and B buffers of :func:`t32_packs` (``csrc/mlp_tf32_mma_tile.cuh``).

Beside each kernel is its plain PyTorch version (:func:`mlp_fwd_plain`,
:func:`mlp_bwd_plain`), which repeats the kernel's arithmetic: operands
rounded to the compute type, f32 products and sums, activations rounded after
each leaky, and the backward's roundings of ``_backward_tile``. A wrapper
takes the plain version only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from nerf_and_dietnerf_tpu_torch.models.mlp import (
    N_TRUNK_LAYERS,
    SKIP_AFTER,
    MLPConfig,
    Params,
)
from nerf_and_dietnerf_tpu_torch.ops.kernel_lib import (
    bwd_scratch,
    check_tensors,
    flat,
    launched,
    load,
    stream_of,
    uses_kernel,
)

# Limits of the kernels' shared-memory tiles (csrc/mlp_common.cuh,
# csrc/mlp_mma_tile.cuh).
MAX_WIDTH, MAX_XYZ, MAX_DIR = 256, 64, 32

# --------------------------------------------------------------------------- #
# Flat parameter layout shared with csrc/mlp_common.cuh                        #
# --------------------------------------------------------------------------- #

def _trunk_w(layer: int) -> int:
    return layer if layer < SKIP_AFTER else layer + 1


def weight_shapes(config: MLPConfig) -> Tuple[List[Tuple[int, int]], List[int]]:
    """``(K, N)`` of each weight matrix and the width of each bias, in the
    kernels' order (the JAX package's ``_flatten_params`` order)."""
    x, d, h, last = config.xyz_dim, config.dir_dim, config.hidden_dim, config.last_hidden_dim
    ws = [(x, h)] + [(h, h)] * 3 + [(x, h), (h, h)] + [(h, h)] * 3
    bs = [h] * N_TRUNK_LAYERS
    if config.uses_view_dirs:
        ws += [(h, last), (d, last), (last, 3), (h, 1), (d, 1)]
        bs += [last, 3, 1]
    else:
        ws += [(h, h), (h, last), (last, 3), (h, 1)]
        bs += [h, last, 3, 1]
    return ws, bs


def _head_names(config: MLPConfig):
    if config.uses_view_dirs:
        return ("rgb_hidden", "rgb_out", "sigma_out")
    return ("rgb_hidden0", "rgb_hidden", "rgb_out", "sigma_out")


def flatten_params(params: Params, config: MLPConfig, dtype):
    """``(ws, bs)``: weight matrices cast to ``dtype`` (the skip layer's and the
    view heads' split in two), biases in f32."""
    xyz, hid = config.xyz_dim, config.hidden_dim
    ws, bs = [], []
    for layer in range(N_TRUNK_LAYERS):
        p = params["trunk"][layer]
        w = p["kernel"]
        ws += [w[:xyz], w[xyz:]] if layer == SKIP_AFTER else [w]
        bs.append(p["bias"])
    if config.uses_view_dirs:
        wrh = params["rgb_hidden"]["kernel"]
        wsig = params["sigma_out"]["kernel"]
        ws += [wrh[:hid], wrh[hid:], params["rgb_out"]["kernel"], wsig[:hid], wsig[hid:]]
    else:
        ws += [params[k]["kernel"] for k in _head_names(config)]
    bs += [params[k]["bias"] for k in _head_names(config)]
    return ([w.to(dtype).contiguous() for w in ws],
            [b.to(torch.float32).contiguous() for b in bs])


def unflatten_grads(dws, dbs, config: MLPConfig) -> Params:
    """Parameter-tree gradients from the flat kernel/bias gradients."""
    out: Params = {"trunk": []}
    for layer in range(N_TRUNK_LAYERS):
        if layer == SKIP_AFTER:
            kernel = torch.cat([dws[SKIP_AFTER], dws[SKIP_AFTER + 1]], dim=0)
        else:
            kernel = dws[_trunk_w(layer)]
        out["trunk"].append({"kernel": kernel, "bias": dbs[layer]})
    i, b = N_TRUNK_LAYERS + 1, N_TRUNK_LAYERS
    if config.uses_view_dirs:
        out["rgb_hidden"] = {"kernel": torch.cat([dws[i], dws[i + 1]], 0), "bias": dbs[b]}
        out["rgb_out"] = {"kernel": dws[i + 2], "bias": dbs[b + 1]}
        out["sigma_out"] = {"kernel": torch.cat([dws[i + 3], dws[i + 4]], 0), "bias": dbs[b + 2]}
    else:
        for j, name in enumerate(_head_names(config)):
            out[name] = {"kernel": dws[i + j], "bias": dbs[b + j]}
    return out


def mlp_leaves(params: Params, config: MLPConfig) -> List[torch.Tensor]:
    """Kernel and bias of each dense layer, in creation order."""
    layers = list(params["trunk"]) + [params[k] for k in _head_names(config)]
    return [t for p in layers for t in (p["kernel"], p["bias"])]


def tree_from_leaves(leaves, config: MLPConfig) -> Params:
    pairs = [{"kernel": leaves[2 * i], "bias": leaves[2 * i + 1]}
             for i in range(len(leaves) // 2)]
    out: Params = {"trunk": pairs[:N_TRUNK_LAYERS]}
    for name, p in zip(_head_names(config), pairs[N_TRUNK_LAYERS:]):
        out[name] = p
    return out


# --------------------------------------------------------------------------- #
# Weight packs of the bf16 tensor-core kernels (csrc/mlp_mma_tile.cuh)         #
# --------------------------------------------------------------------------- #

def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def _layout_of(shapes) -> Tuple[List[Tuple[int, int, int]], int]:
    layout, off = [], 0
    for k, n in shapes:
        layout.append((off, _pad16(k), _pad16(n)))
        off += _pad16(k) * _pad16(n)
    return layout, off


def mma_layout(config: MLPConfig) -> Tuple[List[Tuple[int, int, int]], int]:
    """``(offset, pad16(K), pad16(N))`` of each weight matrix in either pack,
    in :func:`weight_shapes` order, and the elements of a pack."""
    return _layout_of(weight_shapes(config)[0])


@functools.lru_cache(maxsize=None)
def _pack_index(shapes, kinds, device):
    """For the packs ``kinds`` one after the other, the index of each entry in
    ``flat(ws)`` followed by one zero (every pad points at that zero), and
    that zero, both on ``device``."""
    layout, total = _layout_of(shapes)
    pad = sum(k * n for k, n in shapes)
    parts = []
    for kind in kinds:
        idx = torch.full((total,), pad, dtype=torch.long)
        src = 0
        for (k, n), (off, kp, np_) in zip(shapes, layout):
            w = torch.arange(src, src + k * n).view(k, n)
            if kind == "f":
                idx[off:off + kp * np_].view(np_, kp)[:n, :k] = w.t()
            else:
                idx[off:off + kp * np_].view(kp, np_)[:k, :n] = w
            src += k * n
        parts.append(idx)
    return torch.cat(parts).to(device), torch.zeros(1, dtype=torch.bfloat16, device=device)


def _packs(ws, config: MLPConfig, kinds) -> List[torch.Tensor]:
    """The bf16 packs ``kinds`` of ``ws``: one concatenation and one gather
    through a cached index, whatever the number of matrices."""
    for kind in kinds:
        if kind not in ("f", "b"):
            raise ValueError(f"pack kind must be 'f' or 'b', got {kind!r}")
    shapes = tuple(weight_shapes(config)[0])
    idx, zero = _pack_index(shapes, tuple(kinds), ws[0].device)
    return list(flat(list(ws) + [zero])[idx].split(_layout_of(shapes)[1]))


def pack_mma_weights(ws, config: MLPConfig, kind: str) -> torch.Tensor:
    """One flat bf16 pack of the weights, every matrix zero-padded to
    multiples of 16 (so every row is 32-byte aligned): ``kind="f"`` holds
    each W^T as ``(pad16(N), pad16(K))`` (the forward's operand, x @ W),
    ``kind="b"`` each W as ``(pad16(K), pad16(N))`` (the chain back's, g @ W^T)."""
    return _packs(ws, config, (kind,))[0]


# --------------------------------------------------------------------------- #
# Weight buffer of the f32 tensor-core forward (csrc/mlp_tf32_tile.cuh)        #
# --------------------------------------------------------------------------- #

TF32_CHUNK = 16      # contraction columns of a full ring stage (KS)
N_TF32_PRODUCTS = 11  # matrices 0..10 run on the tensor cores; 11.. are the heads


def _pad8(v: int) -> int:
    return -(-v // 8) * 8


def _npad(n: int) -> int:
    """N of the ``wgmma`` that computes a layer of width ``n``."""
    return 64 if n <= 64 else 128 if n <= 128 else 256


def _tf32_layout_of(shapes, pad_n=_npad) -> Tuple[List[Tuple[int, int, int]], int]:
    """``(offset, pad8(K), pad_n(N))`` of the 11 product matrices, and the
    floats of a pack."""
    layout, off = [], 0
    for k, n in shapes[:N_TF32_PRODUCTS]:
        layout.append((off, _pad8(k), pad_n(n)))
        off += _pad8(k) * pad_n(n)
    return layout, off


def tf32_layout(config: MLPConfig) -> Tuple[List[Tuple[int, int, int]], int]:
    """``(offset, pad8(K), npad(N))`` of each of the 11 product matrices in
    either TF32 pack, and the floats of a pack."""
    return _tf32_layout_of(weight_shapes(config)[0])


def tf32_stage_offset(n, k, np_: int, kp: int):
    """Float offset of entry ``(n, k)`` of W^T within its matrix's block (as
    ``stage_offset`` in ``csrc/mlp_tf32_tile.cuh``; ``n``, ``k`` integer
    tensors): chunk ``k // 16`` (``kc`` = 16, or 8 for a last chunk of 8) holds
    ``np_ x kc`` floats as core matrices of 8 rows x 4 columns, those of an
    8-row group side by side."""
    k0 = TF32_CHUNK * (k // TF32_CHUNK)
    kc = torch.clamp(kp - k0, max=TF32_CHUNK)
    kk = k - k0
    return np_ * k0 + ((n // 8) * (kc // 4) + kk // 4) * 32 + (n % 8) * 4 + kk % 4


@functools.lru_cache(maxsize=None)
def _tf32_index(shapes, device):
    """Index of each entry of a TF32 pack in ``flat(ws[:11])`` followed by one
    zero (every pad points at that zero), and that zero, both on ``device``."""
    layout, total = _tf32_layout_of(shapes)
    pad = sum(k * n for k, n in shapes[:N_TF32_PRODUCTS])
    idx = torch.full((total,), pad, dtype=torch.long)
    src = 0
    for (k, n), (off, kp, np_) in zip(shapes, layout):
        nn, kk = torch.meshgrid(torch.arange(n), torch.arange(k), indexing="ij")
        idx[off + tf32_stage_offset(nn, kk, np_, kp)] = src + kk * n + nn
        src += k * n
    return idx.to(device), torch.zeros(1, dtype=torch.float32, device=device)


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``; the low 13 bits are zero."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``: hi = round_tf32(v), lo = round_tf32(v - hi) (v - hi is
    exact in f32), so hi + lo is v to about 2^-22 relative."""
    hi = round_tf32(v)
    return hi, round_tf32(v - hi)


def tf32_weights(ws, config: MLPConfig) -> torch.Tensor:
    """The f32 forward's weight buffer: the hi pack and the lo pack of the 11
    product matrices (W^T in ring-stage layout, zero pads; one gather through
    a cached index, then the split), then the head matrices 11.. flat, f32."""
    shapes = tuple(weight_shapes(config)[0])
    idx, zero = _tf32_index(shapes, ws[0].device)
    hi, lo = split_tf32(flat(list(ws[:N_TF32_PRODUCTS]) + [zero])[idx])
    return torch.cat([hi, lo, flat(ws[N_TF32_PRODUCTS:])])


# --------------------------------------------------------------------------- #
# Weight buffers of the f32 tensor-core backward (csrc/mlp_tf32_mma_tile.cuh)  #
# --------------------------------------------------------------------------- #

T32_CHUNK = 16  # contraction columns of a ring chunk of the f32 tensor-core backward


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def t32_layout(config: MLPConfig) -> Tuple[List[Tuple[int, int, int]], int]:
    """``(offset, pad16(K), pad16(N))`` of each of the 11 product matrices in
    each pack of the f32 tensor-core backward, and the floats of a pack."""
    layout, off = [], 0
    for k, n in weight_shapes(config)[0][:N_TF32_PRODUCTS]:
        layout.append((off, _pad16(k), _pad16(n)))
        off += _pad16(k) * _pad16(n)
    return layout, off


def t32_offset(r: torch.Tensor, c: torch.Tensor, rows: int) -> torch.Tensor:
    """Where a pack matrix of ``rows`` (padded) outputs stores output ``r``,
    contraction column ``c`` (``t32_col`` of ``csrc/mlp_tf32_mma_tile.cuh``):
    chunk ``c // 16`` is ``rows x 16`` floats in one piece; in its row ``r``
    the two 8-column halves swap on rows with ``r & 2``, and each half holds
    its columns in the order 0 4 1 5 2 6 3 7, so the columns t and t + 4 that
    one lane of ``mma.m16n8k8`` reads lie side by side."""
    j = c % T32_CHUNK
    col = (((j // 8) ^ (r // 2)) % 2) * 8 + 2 * (j % 4) + (j % 8) // 4
    return (c // T32_CHUNK) * rows * T32_CHUNK + r * T32_CHUNK + col


@functools.lru_cache(maxsize=None)
def _t32_index(shapes, device):
    """For the F pack, then the B pack, of the f32 tensor-core backward, the
    index of each entry in ``flat(ws[:11])`` followed by one zero (every pad
    points at that zero), and that zero, both on ``device``."""
    layout, off = [], 0
    for k, n in shapes[:N_TF32_PRODUCTS]:
        layout.append((off, _pad16(k), _pad16(n)))
        off += _pad16(k) * _pad16(n)
    pad = sum(k * n for k, n in shapes[:N_TF32_PRODUCTS])
    parts = []
    for kind in ("f", "b"):
        idx = torch.full((off,), pad, dtype=torch.long)
        src = 0
        for (k, n), (o, kp, np_) in zip(shapes, layout):
            kk, nn = torch.meshgrid(torch.arange(k), torch.arange(n), indexing="ij")
            # F: W^T, rows the N outputs over the K contraction; B: W, rows K over N.
            at = t32_offset(nn, kk, np_) if kind == "f" else t32_offset(kk, nn, kp)
            idx[o + at] = src + kk * n + nn
            src += k * n
        parts.append(idx)
    return torch.cat(parts).to(device), torch.zeros(1, dtype=torch.float32, device=device)


def t32_packs(ws, config: MLPConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 tensor-core backward's two weight buffers, F and B: W^T as
    ``(pad16(N), pad16(K))`` and W as ``(pad16(K), pad16(N))`` for each of the
    11 product matrices, f32, zero pads, laid out by :func:`t32_offset` (one
    gather through a cached index), then the head matrices 11.. flat. The
    kernels split the weights into TF32 hi and lo in registers, as
    :func:`split_tf32` would."""
    shapes = tuple(weight_shapes(config)[0])
    idx, zero = _t32_index(shapes, ws[0].device)
    heads = flat(ws[N_TF32_PRODUCTS:])
    f, b = flat(list(ws[:N_TF32_PRODUCTS]) + [zero])[idx].split(t32_layout(config)[1])
    return tuple(torch.cat([p, heads]) for p in (f, b))


def _weights_for(lib: ctypes.CDLL, ws, config: MLPConfig, cd, kinds):
    """The weight buffers an MLP kernel's library reads: the packs ``kinds``
    in bf16 (their size checked against the library's); in f32, for ``kinds
    == ("t",)`` (f32 B1 and B6's forward) the TF32 buffer of
    :func:`tf32_weights`, for ``kinds == ("tf", "tb")`` (the f32 tensor-core
    backwards: B2, B4-B7) the F and B buffers of :func:`t32_packs`, for
    ``("tf",)`` (the f32 compositing forwards: B4, B7) its F buffer (the pack
    sizes checked against the library's), else (``("f",)``, the f32 FMA
    forward of B6 at wide encodings) the flat weights."""
    has_dir = int(config.uses_view_dirs)
    dims = (has_dir, config.xyz_dim, config.dir_dim if has_dir else 0, config.hidden_dim,
            config.last_hidden_dim)
    if kinds == ("t",):
        if tf32_layout(config)[1] != lib.nerf_mlp_tf32_pack_elems(*dims):
            raise RuntimeError("kernel and wrapper disagree on the TF32 weight-pack layout")
        return [tf32_weights(ws, config)]
    if kinds in (("tf", "tb"), ("tf",)):
        if t32_layout(config)[1] != lib.nerf_mlp_t32_pack_elems(*dims):
            raise RuntimeError("kernel and wrapper disagree on the f32 backward's pack layout")
        return list(t32_packs(ws, config))[:len(kinds)]
    if cd != torch.bfloat16:  # the f32 FMA forward (B6 at wide encodings)
        return [flat(ws)]
    packs = _packs(ws, config, kinds)
    if packs[0].numel() != lib.nerf_mlp_mma_pack_elems(*dims):
        raise RuntimeError("kernel and wrapper disagree on the weight-pack layout")
    return packs


# --------------------------------------------------------------------------- #
# Plain versions                                                               #
# --------------------------------------------------------------------------- #

def _leaky(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


def _leaky_bwd(post, g, alpha):
    """The sign of the post-activation picks the branch (ties >= 0)."""
    return torch.where(post >= 0, g, alpha * g)


def _round(v, cd):
    """``v`` rounded to the compute type ``cd``, held in ``v``'s own type."""
    return v if cd == torch.float32 else v.to(cd).to(v.dtype)


def _forward_plain(ws, bs, config: MLPConfig, x, d, cd, work=torch.float32):
    alpha = config.leaky_relu_alpha
    W = [w.to(work) for w in ws]
    x = x.to(work)
    d = d.to(work) if d is not None else None
    acts = []
    h = x
    for layer in range(N_TRUNK_LAYERS):
        if layer == SKIP_AFTER:
            pre = x @ W[SKIP_AFTER] + h @ W[SKIP_AFTER + 1] + bs[layer]
        else:
            pre = h @ W[_trunk_w(layer)] + bs[layer]
        h = _round(_leaky(pre, alpha), cd)
        acts.append(h)
    b = N_TRUNK_LAYERS
    if config.uses_view_dirs:
        rgb_h = _round(_leaky(h @ W[9] + d @ W[10] + bs[b], alpha), cd)
        rgb = rgb_h @ W[11] + bs[b + 1]
        sigma = h @ W[12] + d @ W[13] + bs[b + 2]
        acts.append(rgb_h)
    else:
        r0 = _round(_leaky(h @ W[9] + bs[b], alpha), cd)
        rgb_h = _round(_leaky(r0 @ W[10] + bs[b + 1], alpha), cd)
        rgb = rgb_h @ W[11] + bs[b + 2]
        sigma = h @ W[12] + bs[b + 3]
        acts += [r0, rgb_h]
    return torch.cat([rgb, sigma], dim=-1), acts


def mlp_fwd_plain(ws, bs, config: MLPConfig, x, d, compute_dtype) -> torch.Tensor:
    """Plain version of B1: ``(n, 4)`` f32 raw output."""
    return _forward_plain(ws, bs, config, x, d, compute_dtype)[0]


def mlp_bwd_plain(ws, bs, config: MLPConfig, x, d, g, compute_dtype, work=torch.float32):
    """Plain version of B2: ``(dws, dbs, dx, dd)`` for the cotangent ``g``
    (n, 4), with the roundings of the JAX package's ``_backward_tile``.
    ``work`` is the type of the products and sums (float64 gives the chain
    with the same roundings but nearly exact sums)."""
    cd = compute_dtype
    alpha = config.leaky_relu_alpha
    W = [w.to(work) for w in ws]
    xf = x.to(work)
    df = d.to(work) if d is not None else None
    _, acts = _forward_plain(ws, bs, config, x, d, cd, work)
    g = g.to(work)
    grgb, gsig = g[:, 0:3], g[:, 3:4]
    gsig_cd = _round(gsig, cd)
    alpha_cd = float(_round(torch.tensor(alpha, dtype=torch.float32), cd))

    def head_grad(post, gg):  # cotangent rounded to cd; slope and product in cd
        t = _round(gg, cd)
        return torch.where(post >= 0, t, _round(alpha_cd * t, cd))

    dW: List[Optional[torch.Tensor]] = [None] * len(ws)
    dB: List[Optional[torch.Tensor]] = [None] * len(bs)
    h8 = acts[N_TRUNK_LAYERS - 1]
    b = N_TRUNK_LAYERS
    dd = None
    if config.uses_view_dirs:
        rgb_h = acts[-1]
        dW[11], dB[b + 1] = rgb_h.T @ grgb, grgb.sum(0)
        g_rgb_h = head_grad(rgb_h, grgb @ W[11].T)
        dW[9], dW[10], dB[b] = h8.T @ g_rgb_h, df.T @ g_rgb_h, g_rgb_h.sum(0)
        dW[12], dW[13], dB[b + 2] = h8.T @ gsig, df.T @ gsig, gsig.sum(0)
        g_h = g_rgb_h @ W[9].T + gsig_cd @ W[12].T
        dd = g_rgb_h @ W[10].T + gsig_cd @ W[13].T
    else:
        r0, rgb_h = acts[-2], acts[-1]
        dW[11], dB[b + 2] = rgb_h.T @ grgb, grgb.sum(0)
        g_rgb_h = head_grad(rgb_h, grgb @ W[11].T)
        dW[10], dB[b + 1] = r0.T @ g_rgb_h, g_rgb_h.sum(0)
        g_r0 = head_grad(r0, g_rgb_h @ W[10].T)
        dW[9], dB[b] = h8.T @ g_r0, g_r0.sum(0)
        dW[12], dB[b + 3] = h8.T @ gsig, gsig.sum(0)
        g_h = g_r0 @ W[9].T + gsig_cd @ W[12].T

    g_x = torch.zeros_like(xf)
    for layer in reversed(range(N_TRUNK_LAYERS)):
        g_pre = _round(_leaky_bwd(acts[layer], g_h, alpha), cd)
        prev = acts[layer - 1] if layer > 0 else xf
        dB[layer] = g_pre.sum(0)
        if layer == SKIP_AFTER:
            dW[SKIP_AFTER] = xf.T @ g_pre
            dW[SKIP_AFTER + 1] = prev.T @ g_pre
            g_x = g_x + g_pre @ W[SKIP_AFTER].T
            g_h = g_pre @ W[SKIP_AFTER + 1].T
        else:
            wi = _trunk_w(layer)
            dW[wi] = prev.T @ g_pre
            g_h = g_pre @ W[wi].T
    return dW, dB, g_x + g_h, dd


# --------------------------------------------------------------------------- #
# Wrappers                                                                     #
# --------------------------------------------------------------------------- #

def check_params(config: MLPConfig, ws, bs, cd, dev) -> None:
    """The compute type, the widths and the flat parameters a kernel takes."""
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {cd}")
    if (config.hidden_dim > MAX_WIDTH or config.last_hidden_dim > MAX_WIDTH
            or config.xyz_dim > MAX_XYZ or config.dir_dim > MAX_DIR):
        raise ValueError(f"MLP widths exceed the kernels' limits: {config}")
    w_shapes, b_shapes = weight_shapes(config)
    if len(ws) != len(w_shapes) or len(bs) != len(b_shapes):
        raise ValueError("parameter list does not match the MLP config")
    check_tensors([(w, s, cd) for w, s in zip(ws, w_shapes)]
                  + [(b, (s,), torch.float32) for b, s in zip(bs, b_shapes)], dev)


def _check(config: MLPConfig, ws, bs, x, d, cd, n: int) -> None:
    tensors = [(x, (n, config.xyz_dim), cd)]
    if config.uses_view_dirs:
        tensors.append((d, (n, config.dir_dim), cd))
    check_tensors(tensors, x.device)
    check_params(config, ws, bs, cd, x.device)


def mlp_fwd(ws, bs, config: MLPConfig, x, d, compute_dtype) -> torch.Tensor:
    """B1: ``(n, 4)`` f32 raw radiance. ``x`` (n, xyz) and ``d`` (n, dir) in
    the compute dtype, ``ws`` / ``bs`` from :func:`flatten_params`."""
    if not uses_kernel(x):
        return mlp_fwd_plain(ws, bs, config, x, d, compute_dtype)
    n = x.shape[0]
    _check(config, ws, bs, x, d, compute_dtype, n)
    out = torch.empty((n, 4), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = load("mlp_fwd")
    kind = "f" if compute_dtype == torch.bfloat16 else "t"
    (w,) = _weights_for(lib, ws, config, compute_dtype, (kind,))
    b = flat(bs)
    has_dir = int(config.uses_view_dirs)
    rc = lib.nerf_mlp_fwd(
        int(compute_dtype == torch.bfloat16), has_dir, x.data_ptr(),
        d.data_ptr() if has_dir else None, w.data_ptr(), b.data_ptr(), out.data_ptr(),
        n, config.xyz_dim, config.dir_dim if has_dir else 0, config.hidden_dim,
        config.last_hidden_dim, config.leaky_relu_alpha, stream_of(x.device),
    )
    launched("mlp_fwd", rc)
    return out


def mlp_bwd(ws, bs, config: MLPConfig, x, d, g, compute_dtype, before_launch=None):
    """B2: ``(dws, dbs, dx, dd)`` for the (n, 4) f32 cotangent ``g``. Weight
    and bias gradients are f32 sums over all rows, bitwise reproducible.
    ``before_launch``, if given, is called just before the kernel's launch,
    after every other operation of the call (``chip_smoke.py`` launches a
    kernel there that leaves NaN in shared memory)."""
    if not uses_kernel(x):
        return mlp_bwd_plain(ws, bs, config, x, d, g, compute_dtype)
    n = x.shape[0]
    _check(config, ws, bs, x, d, compute_dtype, n)
    if g.device != x.device or g.dtype != torch.float32 or tuple(g.shape) != (n, 4) \
            or not g.is_contiguous():
        raise ValueError(f"cotangent must be contiguous ({n}, 4) float32 on {x.device}")
    lib = load("mlp_bwd")
    dev = x.device
    has_dir = int(config.uses_view_dirs)
    dir_dim = config.dir_dim if has_dir else 0
    dx = torch.empty((n, config.xyz_dim), dtype=torch.float32, device=dev)
    dd = torch.empty((n, dir_dim), dtype=torch.float32, device=dev) if has_dir else None
    dparams = torch.empty((param_count(config, lib),), dtype=torch.float32, device=dev)
    if n == 0:
        dparams.zero_()
    else:
        is_bf16 = int(compute_dtype == torch.bfloat16)
        rows = lib.nerf_mlp_bwd_tile_rows(is_bf16)
        partial, acts, n_blocks = bwd_scratch(dparams.numel(), compute_dtype, dev,
                                              -(-n // rows),
                                              lib.nerf_mlp_bwd_tile_act_elems(is_bf16))
        kinds = ("f", "b") if is_bf16 else ("tf", "tb")
        w, wt = _weights_for(lib, ws, config, compute_dtype, kinds)
        b = flat(bs)
        if before_launch is not None:
            before_launch()
        rc = lib.nerf_mlp_bwd(
            is_bf16, has_dir, x.data_ptr(),
            d.data_ptr() if has_dir else None, w.data_ptr(), wt.data_ptr(), b.data_ptr(),
            g.data_ptr(), dx.data_ptr(), dd.data_ptr() if has_dir else None,
            partial.data_ptr(), acts.data_ptr(), dparams.data_ptr(), n_blocks,
            n, config.xyz_dim, dir_dim, config.hidden_dim, config.last_hidden_dim,
            config.leaky_relu_alpha, stream_of(dev),
        )
        launched("mlp_bwd", rc)
    dws, dbs = split_dparams(dparams, config)
    return dws, dbs, dx, dd


def param_count(config: MLPConfig, lib: ctypes.CDLL) -> int:
    """Entries of the flat f32 gradient a backward kernel writes (weights,
    then biases), checked against the layout of the backward library ``lib``."""
    w_shapes, b_shapes = weight_shapes(config)
    total = sum(k * m for k, m in w_shapes) + sum(b_shapes)
    has_dir = int(config.uses_view_dirs)
    if total != lib.nerf_mlp_param_count(
            has_dir, config.xyz_dim, config.dir_dim if has_dir else 0, config.hidden_dim,
            config.last_hidden_dim):
        raise RuntimeError("kernel and wrapper disagree on the parameter layout")
    return total


def split_dparams(dparams: torch.Tensor, config: MLPConfig):
    """The flat gradient as ``(dws, dbs)`` views in :func:`weight_shapes` order."""
    w_shapes, b_shapes = weight_shapes(config)
    parts = torch.split(dparams, [k * m for k, m in w_shapes] + list(b_shapes))
    return ([p.view(s) for p, s in zip(parts[: len(w_shapes)], w_shapes)],
            list(parts[len(w_shapes):]))


# --------------------------------------------------------------------------- #
# autograd.Function: drop-in for models.mlp.apply_mlp                          #
# --------------------------------------------------------------------------- #

def _input_dtype(cd):
    return torch.bfloat16 if cd == torch.bfloat16 else torch.float32


class FusedMLP(torch.autograd.Function):
    """B1 forward, B2 backward. Inputs after the encodings are the parameter
    leaves of :func:`mlp_leaves`."""

    @staticmethod
    def forward(ctx, config, cd, enc_xyz, enc_dir, *leaves):
        ws, bs = flatten_params(tree_from_leaves(leaves, config), config, cd)
        x = enc_xyz.to(_input_dtype(cd)).contiguous()
        d = enc_dir.to(_input_dtype(cd)).contiguous() if enc_dir is not None else None
        ctx.config, ctx.cd = config, cd
        ctx.save_for_backward(x, d, *leaves)
        return mlp_fwd(ws, bs, config, x, d, cd)

    @staticmethod
    def backward(ctx, g):
        config, cd = ctx.config, ctx.cd
        x, d, *leaves = ctx.saved_tensors
        ws, bs = flatten_params(tree_from_leaves(leaves, config), config, cd)
        dws, dbs, dx, dd = mlp_bwd(ws, bs, config, x, d, g.float().contiguous(), cd)
        dleaves = mlp_leaves(unflatten_grads(dws, dbs, config), config)
        dleaves = [dl.to(leaf.dtype) for dl, leaf in zip(dleaves, leaves)]
        return (None, None, dx, dd, *dleaves)


def apply_mlp_fused(params: Params, config: MLPConfig, enc_xyz: torch.Tensor,
                    enc_dir: torch.Tensor | None = None,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel drop-in for :func:`models.mlp.apply_mlp` (pre-encoded inputs in,
    ``(n, 4)`` f32 raw radiance out)."""
    if config.uses_view_dirs and enc_dir is None:
        raise ValueError("this MLP config requires encoded view directions")
    if not config.uses_view_dirs:
        enc_dir = None
    return FusedMLP.apply(config, compute_dtype, enc_xyz, enc_dir, *mlp_leaves(params, config))
