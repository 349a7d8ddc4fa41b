"""Build, load and launch bookkeeping of the port's CUDA kernels.

Every kernel is CUDA C++ for ``sm_90a`` in ``csrc/``, built with ``nvcc`` at
first use into ``build/kernels/`` (one shared library per kernel, all compiled
in parallel) and called through ``ctypes``. A library's name carries a hash of
the flags, its source and every header that source includes, so a stale build
is never loaded. The wrapper modules (``ops/raymarch_cuda.py`` for B1/B2,
``ops/research_kernels_cuda.py`` for B4-B7, ``ops/probe_kernels_cuda.py`` for
the probes P1-P7) load their own libraries from here, and count each launch
in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = {
    "mlp_fwd": "mlp_fwd.cu",                      # B1
    "mlp_bwd": "mlp_bwd.cu",                      # B2
    "raymarch_fwd": "raymarch_fwd.cu",            # B6 forward
    "raymarch_bwd": "raymarch_bwd.cu",            # B6 backward
    "raymarch_comp_fwd": "raymarch_comp_fwd.cu",  # B7 forward
    "raymarch_comp_bwd": "raymarch_comp_bwd.cu",  # B7 backward
    "mlp_comp_fwd": "mlp_comp_fwd.cu",            # B4 forward
    "mlp_comp_bwd": "mlp_comp_bwd.cu",            # B4 backward
    "mlp_loss_comp": "mlp_loss_comp.cu",          # B5
    "probe_mma": "probe_mma.cu",                  # P1
    "probe_mlp_epilogue": "probe_mlp_epilogue.cu",  # P2
    "probe_mlp_chains": "probe_mlp_chains.cu",    # P3
    "probe_expand": "probe_expand.cu",            # P4, P5, P6
    "probe_enccost": "probe_enccost.cu",          # P7
}
# Launch counters: one per kernel. A library with several kernels has several.
KERNEL_NAMES = tuple(n for n in KERNEL_SOURCES if n != "probe_expand") + (
    "probe_expand_a", "probe_expand_b", "probe_expand_c")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Kernel launches since the last reset_launch_counts(): one per wrapper call
# that launched its kernel, never for the plain version.
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launched(name: str, rc: int) -> None:
    """Raise on a kernel's CUDA error code, else count its launch."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


# --------------------------------------------------------------------------- #
# Build and load                                                               #
# --------------------------------------------------------------------------- #

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_closure(src: Path) -> List[Path]:
    """``src`` and every file it includes with ``#include "..."``, transitively
    (the headers beside it in ``csrc/``), sorted."""
    seen: List[Path] = []
    todo = [src]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        todo += [f.parent / name for name in _INCLUDE.findall(f.read_text())
                 if (f.parent / name).exists()]
    return sorted(seen)


def lib_path(name: str, csrc_dir: Path = CSRC_DIR) -> Path:
    """The library's path, named by a hash of the flags, its source and every
    header that source includes: an edit to any of them builds a new one."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in source_closure(csrc_dir / KERNEL_SOURCES[name]):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")
    return nvcc


def build_kernels() -> Dict[str, object]:
    """Compile every kernel library not yet built, one ``nvcc`` per source, all
    started together. Returns ``{"seconds": wall time, "log": compiler output}``
    (the log holds ``-Xptxas -v``'s registers, shared memory and spills)."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in KERNEL_SOURCES.items():
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(".tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    log = []
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        log.append(f"--- {name}\n{text}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    return {"seconds": time.perf_counter() - t0, "log": "\n".join(log)}


_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# R, S, L, Ld, D, xyz, dir, hid, last, alpha, stream of the ray-march kernels.
_RAY_TAIL = [_i] * 9 + [_f, _p]
# The slab size every backward library exports (csrc/grad_slabs.cuh).
_BWD_SCRATCH = {"nerf_mlp_param_count": ([_i] * 5, ctypes.c_longlong)}
# R, S, xyz, dir, hid, last, alpha of the MLP + compositing kernels.
_COMP_TAIL = [_i] * 6 + [_f]
# Each library's C functions: (argtypes, restype).
# The weight-pack sizes of the bf16 and f32 tensor-core tiles
# (csrc/mlp_mma_tile.cuh, csrc/mlp_tf32_tile.cuh).
_MMA_PACK = {"nerf_mlp_mma_pack_elems": ([_i] * 5, ctypes.c_longlong)}
_TF32_PACK = {"nerf_mlp_tf32_pack_elems": ([_i] * 5, ctypes.c_longlong)}
# ... and of the f32 tensor-core backwards and compositing forwards
# (csrc/mlp_tf32_mma_tile.cuh).
_T32_PACK = {"nerf_mlp_t32_pack_elems": ([_i] * 5, ctypes.c_longlong)}
# The tile rows and activation slots of a backward, by compute type (B2, B6).
_BWD_TILE = {"nerf_mlp_bwd_tile_rows": ([_i], _i),
             "nerf_mlp_bwd_tile_act_elems": ([_i], ctypes.c_longlong)}
# The ray groups, activation slots and slab rows of a compositing backward,
# by compute type (B7, B5, B4; csrc/comp_exports.cuh).
_COMP_BWD = {"nerf_comp_groups": ([_i, _i, _i], _i),
             "nerf_comp_act_elems": ([_i, _i], ctypes.c_longlong),
             "nerf_comp_dx_rows": ([_i], _i)}
_SIGNATURES = {
    "mlp_fwd": {"nerf_mlp_fwd": ([_i, _i] + [_p] * 5 + [_i] * 5 + [_f, _p], _i), **_MMA_PACK,
                **_TF32_PACK},
    "mlp_bwd": {"nerf_mlp_bwd": ([_i, _i] + [_p] * 11 + [_i] * 6 + [_f, _p], _i),
                **_BWD_TILE, **_MMA_PACK, **_T32_PACK, **_BWD_SCRATCH},
    "raymarch_fwd": {"nerf_rm_fwd": ([_i, _i] + [_p] * 5 + _RAY_TAIL, _i),
                     "nerf_rm_fwd_tf32_tile": ([_i, _i], _i), **_MMA_PACK, **_TF32_PACK},
    "raymarch_bwd": {"nerf_rm_bwd": ([_i, _i] + [_p] * 11 + [_i] + _RAY_TAIL, _i),
                     **_BWD_TILE, **_MMA_PACK, **_T32_PACK, **_BWD_SCRATCH},
    "raymarch_comp_fwd": {"nerf_rm_comp_fwd": ([_i, _i] + [_p] * 7 + _RAY_TAIL, _i),
                          **_MMA_PACK, **_T32_PACK},
    "raymarch_comp_bwd": {"nerf_rm_comp_bwd": ([_i, _i] + [_p] * 13 + [_i] + _RAY_TAIL, _i),
                          **_COMP_BWD, **_MMA_PACK, **_T32_PACK, **_BWD_SCRATCH},
    "mlp_comp_fwd": {"nerf_mlp_comp_fwd": ([_i, _i] + [_p] * 8 + _COMP_TAIL + [_p], _i),
                     **_MMA_PACK, **_T32_PACK},
    "mlp_comp_bwd": {"nerf_mlp_comp_bwd": ([_i, _i] + [_p] * 16 + [_i] + _COMP_TAIL + [_p], _i),
                     **_COMP_BWD, **_MMA_PACK, **_T32_PACK, **_BWD_SCRATCH},
    "mlp_loss_comp": {"nerf_mlp_loss_comp": ([_i, _i] + [_p] * 14 + [_i] + _COMP_TAIL + [_f, _p],
                                             _i),
                      **_COMP_BWD, **_MMA_PACK, **_T32_PACK, **_BWD_SCRATCH},
    "probe_mma": {"nerf_probe_mma": ([_p] * 3 + [_i] * 5 + [_p], _i),
                  "nerf_probe_mma_unit_rows": ([], _i)},
    # variant, x, d, w, b, out, n, xyz, dir, hid, last, alpha, stream
    "probe_mlp_epilogue": {"nerf_probe_mlp_epilogue": ([_i] + [_p] * 5 + [_i] * 5 + [_f, _p], _i)},
    "probe_mlp_chains": {"nerf_probe_mlp_chains": ([_i, _i] + [_p] * 5 + [_i] * 5 + [_f, _p], _i),
                         "nerf_probe_chains_smem": ([_i], ctypes.c_longlong)},
    "probe_expand": {"nerf_probe_expand_a": ([_p, _p, _i, _p], _i),
                     "nerf_probe_expand_b": ([_p, _p] + [_i] * 3 + [_p], _i),
                     "nerf_probe_expand_c": ([_p] * 7 + [_i] * 5 + [_p], _i)},
    # stage, rd, z, out, R, S, L, Ld, D, r_t, stream
    "probe_enccost": {"nerf_probe_enccost": ([_i] + [_p] * 3 + [_i] * 6 + [_p], _i)},
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` (a key of :data:`KERNEL_SOURCES`), built
    first if it is not there."""
    if name not in _LIBS:
        path = lib_path(name)
        if not path.exists():
            build_kernels()
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return _LIBS[name]


# --------------------------------------------------------------------------- #
# What every wrapper checks and passes                                         #
# --------------------------------------------------------------------------- #

def build_variants(name: str, variants: Dict[str, List[str]], out_dir: Path,
                   extra: Dict[str, tuple] = None) -> Dict[str, object]:
    """Measurement builds of the library ``name``: one per entry of
    ``variants`` (label -> extra ``nvcc`` flags such as ``-DNAME``), all
    compiled together into ``out_dir``, never into :data:`BUILD_DIR`, so the
    libraries the port loads are not these. Returns ``{"libs": {label:
    CDLL with the library's signatures and ``extra``'s}, "log": {label:
    compiler output}, "seconds": wall time}``."""
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, flags in variants.items():
        out = out_dir / f"lib{name}-{label}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(out), str(CSRC_DIR / KERNEL_SOURCES[name])]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), out)
    libs, logs, failed = {}, {}, []
    for label, (proc, out) in procs.items():
        logs[label], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(label)
            continue
        lib = ctypes.CDLL(str(out))
        for fn, (argtypes, restype) in {**_SIGNATURES[name], **(extra or {})}.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[label] = lib
    if failed:
        raise RuntimeError(f"nvcc failed for {name} {failed}:\n" +
                           "\n".join(logs[k] for k in failed))
    return {"libs": libs, "log": logs, "seconds": time.perf_counter() - t0}


def use_library(name: str, lib) -> None:
    """Make the wrappers of ``name`` launch ``lib`` (a :func:`build_variants`
    build) from now on in this process; ``None`` restores the port's own."""
    if lib is None:
        _LIBS.pop(name, None)
    else:
        _LIBS[name] = lib


def uses_kernel(x: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors; got device {x.device}")
    return True


def check_tensors(tensors, dev) -> None:
    """Each ``(tensor, shape, dtype)`` must match, lie on ``dev`` and be
    contiguous."""
    for t, shape, dtype in tensors:
        if t is None or t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape):
            got = None if t is None else (tuple(t.shape), t.dtype, t.device)
            raise ValueError(f"expected {tuple(shape)} {dtype} on {dev}, got {got}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def flat(ts) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in ts])


def stream_of(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def bwd_scratch(n_params: int, cd, dev, tiles: int, act_slots: int):
    """``(partial, acts, n_blocks)``: the per-block gradient slabs (``n_params``
    entries each) and activation slots (``act_slots`` elements each) of a
    backward kernel whose blocks walk ``tiles`` units of work, one block per
    SM at most."""
    n_blocks = min(tiles, torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((n_blocks * n_params,), dtype=torch.float32, device=dev)
    acts = torch.empty((n_blocks * act_slots,), dtype=cd, device=dev)
    return partial, acts, n_blocks
