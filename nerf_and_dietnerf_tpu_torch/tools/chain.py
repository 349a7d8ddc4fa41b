"""Distances of the MLP kernels and their plain versions to the f64
evaluation of their chain.

The f64 chain is the plain version with ``work=torch.float64``: the same
roundings to the compute type, f64 products and sums. A :class:`Chain`
names, for one kernel on one set of inputs, its outputs as the kernel, the
plain f32 version and the f64 chain give them; :func:`distances` returns
each output's normwise distance to the f64 chain from the kernel (or from
each of several builds of it) and from the plain version, their ratio and,
with ``pinned``, the kernel's distance to the f64 chain evaluated on the
kernel's own leaky slopes (its backward's recording build, ``branches=``;
used only where :func:`raymarch_cuda.branch_guard` passes). The limits
stay with the callers: ``chip_smoke.py`` holds the bf16 ratios to
``F64_FACTOR_BF16``, ``tools/kernel_ab.py`` reports a parent's and a
change's build side by side.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from nerf_and_dietnerf_tpu_torch.models.mlp import MLPConfig
from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk
from nerf_and_dietnerf_tpu_torch.ops.kernel_lib import flat

F64 = torch.float64


def normwise(a, exact) -> float:
    """|a - exact|_2 / |exact|_2, in f64."""
    exact = exact.double()
    return float((a.double() - exact).norm() / exact.norm().clamp_min(1e-300))


def ratios(out: dict, side: str = "kernel") -> dict:
    """Adds to each entry of ``out`` (``{output: {"plain": d, side: d, ...}}``)
    that holds ``side`` its ``"ratio_<side>_to_plain"``; returns ``out``."""
    for r in out.values():
        if isinstance(r, dict) and side in r:
            r[f"ratio_{side}_to_plain"] = r[side] / max(r["plain"], 1e-300)
    return out


@dataclasses.dataclass
class Chain:
    """One kernel on one set of inputs. Each callable returns ``{output:
    tensor}``; ``kernel`` and ``exact`` take ``branches`` (a
    ``raymarch_cuda.branch_mask``: the kernel records its slopes into it,
    the f64 chain takes them); ``pres()`` gives the f64 chain's
    pre-activations, what :func:`raymarch_cuda.branch_guard` reads."""

    kernel: Callable
    plain: Callable
    exact: Callable
    pres: Callable
    config: MLPConfig
    cd: torch.dtype
    rows: int


def _pres(ws, bs, cfg, x, d, cd):
    def pres():
        out: list = []
        rc._forward_plain(ws, bs, cfg, x, d, cd, F64, pres=out)
        return out
    return pres


def forward_chain(ws, bs, cfg: MLPConfig, x, d, cd) -> Chain:
    """B1 (``mlp_fwd``): its raw output ``out``."""
    return Chain(
        kernel=lambda branches=None: {"out": rc.mlp_fwd(ws, bs, cfg, x, d, cd)},
        plain=lambda: {"out": rc.mlp_fwd_plain(ws, bs, cfg, x, d, cd)},
        exact=lambda branches=None: {"out": rc._forward_plain(ws, bs, cfg, x, d, cd, F64,
                                                               branches)[0]},
        pres=_pres(ws, bs, cfg, x, d, cd), config=cfg, cd=cd, rows=x.shape[0])


def mlp_chain(ws, bs, cfg: MLPConfig, x, d, g, cd) -> Chain:
    """B2 (``mlp_bwd``) for the cotangent ``g``: dx, dd (with view dirs) and
    the flat dparams."""
    def outputs(dws, dbs, dx, dd):
        return {"dx": dx, **({"dd": dd} if dd is not None else {}), "dparams": flat(dws + dbs)}
    return Chain(
        kernel=lambda branches=None: outputs(*rc.mlp_bwd(ws, bs, cfg, x, d, g, cd,
                                                         branches=branches)),
        plain=lambda: outputs(*rc.mlp_bwd_plain(ws, bs, cfg, x, d, g, cd)),
        exact=lambda branches=None: outputs(*rc.mlp_bwd_plain(ws, bs, cfg, x, d, g, cd, F64,
                                                              branches)),
        pres=_pres(ws, bs, cfg, x, d, cd), config=cfg, cd=cd, rows=x.shape[0])


def ray_chain(ws, bs, cfg: MLPConfig, rd, z, g, cd) -> Chain:
    """B6 (``raymarch_fwd``, and ``raymarch_bwd`` for the raw cotangent
    ``g`` where given) on the rays ``(rd, z)``: the raw output, dz (the
    f64 dx through the encoding VJP, its angles and cosines as the plain
    version computes them) and the flat dparams. The f64 chain runs on the
    plain encode's encodings."""
    pts, x, d = rk._mlp_inputs(cfg, rd, z, cd)

    def kernel(branches=None):
        out = {"raw": rk.raymarch_fwd(ws, bs, cfg, rd, z, cd).reshape(-1, 4)}
        if g is not None:
            dws, dbs, dz = rk.raymarch_bwd(ws, bs, cfg, rd, z, g, cd, branches=branches)
            out.update(dz=dz.reshape(-1), dparams=flat(dws + dbs))
        return out

    def plain():
        out = {"raw": rk.raymarch_fwd_plain(ws, bs, cfg, rd, z, cd).reshape(-1, 4)}
        if g is not None:
            dws, dbs, dz = rk.raymarch_bwd_plain(ws, bs, cfg, rd, z, g, cd)
            out.update(dz=dz.reshape(-1), dparams=flat(dws + dbs))
        return out

    def exact(branches=None):
        out = {"raw": rc._forward_plain(ws, bs, cfg, x, d, cd, F64, branches)[0]}
        if g is not None:
            dws, dbs, dx, _ = rc.mlp_bwd_plain(ws, bs, cfg, x, d, g.reshape(-1, 4), cd, F64,
                                               branches)
            out.update(dz=rk._dz_from_dx(cfg, rd, pts, dx, z.shape[1]), dparams=flat(dws + dbs))
        return out
    return Chain(kernel=kernel, plain=plain, exact=exact, pres=_pres(ws, bs, cfg, x, d, cd),
                 config=cfg, cd=cd, rows=z.numel())


def distances(chain: Chain, kernels: Optional[Dict[str, Callable]] = None,
              pinned: bool = False) -> dict:
    """``{output: {"plain": d, side: d, "ratio_<side>_to_plain": r, ...}}``,
    d the normwise distance to the f64 chain, for each side of ``kernels``
    (``{side: callable giving the kernel's outputs}``; default ``{"kernel":
    chain.kernel}``). With ``pinned`` (the kernel side alone): each output's
    ``"kernel_pinned"``, the kernel's distance to the f64 chain on the slopes
    the kernel's recording build took on the same inputs, and ``"branches"``:
    :func:`raymarch_cuda.branch_guard`'s record with ``"recording_bitwise"``,
    whether the recording build's outputs are bitwise the kernel's (the pinned
    distances are left out unless both hold)."""
    kernels = kernels or {"kernel": chain.kernel}
    exact = chain.exact()
    out = {k: {"plain": normwise(v, exact[k])} for k, v in chain.plain().items()}
    got = {}
    for side, fn in kernels.items():
        got = fn()
        for k, v in got.items():
            out[k][side] = normwise(v, exact[k])
        ratios(out, side)
    del exact
    if pinned:
        mask = rc.branch_mask(chain.config, chain.rows, next(iter(got.values())).device)
        recorded = chain.kernel(branches=mask)
        guard = rc.branch_guard(mask, chain.pres(), chain.config, chain.cd)
        guard["recording_bitwise"] = all(torch.equal(recorded[k], got[k]) for k in got)
        out["branches"] = guard
        del recorded
        if guard["ok"] and guard["recording_bitwise"]:
            for k, v in chain.exact(branches=mask).items():
                out[k]["kernel_pinned"] = normwise(got[k], v)
    return out
