#!/usr/bin/env python
"""Where the probes P1 (``csrc/probe_mma.cu``) and P6 (``csrc/probe_expand.cu``)
spend their time: builds cut and stamped copies of their libraries and times
each against the port's own build, in turns, through the port's wrappers.

A cut is a text edit of the kernel's source (:data:`CUTS`; each edited string
must occur in the source exactly once, so a change of the kernel that a cut
no longer fits fails here, and a CPU test applies them all). The copies are
built from a copy of ``csrc/`` under ``build/probe_cuts/`` with the port's
``nvcc`` flags, never into ``build/kernels/``, and the wrappers launch them
for the length of a call (``kernel_lib.use_library``). A cut leaves part of
the work out, so its results are wrong; the time it saves is that part's.

- P1: ``lockstep`` (the two warpgroups start together), ``one_warpgroup``
  (one warpgroup a block), ``no_epilogue`` (a layer's conversion cut to one
  register that the next layer reads, so every product stays live: ptxas
  drops products whose results reach nothing).
- P6: ``no_sin`` (theta in place of its sine), ``fast_sin`` (``__sinf``),
  ``no_product`` (one FMA a column in place of E).
- ``stamped``: ``clock64`` cycles and the ``%globaltimer`` span of block 0,
  thread 0, read back through an added C function: P1 its whole span (so
  the SM clock), P6 its prologue, column loop and write-out.

    python -m nerf_and_dietnerf_tpu_torch.tools.probe_cuts [--out PATH] [--calls N]

One JSON line a case: each build's ms a call in turns (the port's build, then
the cuts, then the same in reverse, ``--calls`` calls a pass between two
CUDA events) and device µs a launch of the kernel (``torch.profiler``); then
one line of stamps a probe. Needs the card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import torch

from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
from nerf_and_dietnerf_tpu_torch.ops import probe_kernels_cuda as pk
from nerf_and_dietnerf_tpu_torch.tools import SEED
from nerf_and_dietnerf_tpu_torch.tools.exp_expand import N_ENC, N_THETA
from nerf_and_dietnerf_tpu_torch.utils.device import resolve_device

OUT_DIR = kl.BUILD_DIR.parent / "probe_cuts"
P1_CASES = ("2048:32:1", "8192:32:1", "512:32:4")
_GLOBALTIMER = '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt{}));\n'
_STAMP_BUF = "#include <stdint.h>\n\n__device__ long long nerf_probe_stamp_buf[4];\n"
_STAMP_READ = ('\nextern "C" int nerf_probe_stamps(long long* out) {\n'
               "  return (int)cudaMemcpyFromSymbol(out, nerf_probe_stamp_buf, "
               "sizeof(nerf_probe_stamp_buf));\n}\n")
# Each cut: (library, [(old, new), ...]) with every old string once in the source.
CUTS = {
    "P1": ("probe_mma", {
        "lockstep": [("__device__ __forceinline__ void stagger(int wg) {\n",
                      "__device__ __forceinline__ void stagger(int wg) {\n  return;\n")],
        "one_warpgroup": [("constexpr int WGS = 2;", "constexpr int WGS = 1;")],
        "no_epilogue": [
            ("      acc_to_frags<WIDTH>(d, a, [s](float p0, float p1) "
             "{ return scale_round(p0, p1, s); });",
             "      a[0][0] = __float_as_uint(d[0]) == 0x7fc00001u ? 1u : a[0][0];")],
        "stamped": [
            ("#include <stdint.h>\n", _STAMP_BUF),
            ("  extern __shared__ __align__(128) unsigned char smem[];\n",
             "  extern __shared__ __align__(128) unsigned char smem[];\n"
             "  const long long k0 = clock64();\n  unsigned long long gt0;\n"
             + _GLOBALTIMER.format(0)),
            ("  if (!staggered) stagger(wg);\n}\n",
             "  if (!staggered) stagger(wg);\n  unsigned long long gt1;\n" + _GLOBALTIMER.format(1)
             + "  if (blockIdx.x == 0 && tid == 0) {\n"
             "    nerf_probe_stamp_buf[0] = clock64() - k0;\n"
             "    nerf_probe_stamp_buf[1] = (long long)(gt1 - gt0);\n  }\n}\n"),
        ]}),
    "P6": ("probe_expand", {
        "no_sin": [("    const float sn = sinf(th);", "    const float sn = th;")],
        "fast_sin": [("    const float sn = sinf(th);", "    const float sn = __sinf(th);")],
        "no_product": [
            ("        if (4 * q + e < MAX_E) acc[4 * q + e] = fmaf(sn, w[e], acc[4 * q + e]);",
             "        if (q == 0 && e == 0) acc[0] = fmaf(sn, w[0], acc[0]);")],
        "stamped": [
            ("#include <stdint.h>\n", _STAMP_BUF),
            ("  const int tid = threadIdx.x, row0 = blockIdx.x * C_ROWS, row = row0 + tid;\n",
             "  const int tid = threadIdx.x, row0 = blockIdx.x * C_ROWS, row = row0 + tid;\n"
             "  const long long k0 = clock64();\n  unsigned long long gt0;\n"
             + _GLOBALTIMER.format(0)),
            ("  __syncthreads();\n\n  float acc[MAX_E];",
             "  __syncthreads();\n  const long long k1 = clock64();\n\n  float acc[MAX_E];"),
            ("  __syncthreads();\n  float* o = outs + tid * E;",
             "  const long long k2 = clock64();\n  __syncthreads();\n  float* o = outs + tid * E;"),
            ("  for (int i = tid; i < rows * E; i += C_ROWS) out[(size_t)row0 * E + i] = outs[i];\n}\n",
             "  for (int i = tid; i < rows * E; i += C_ROWS) out[(size_t)row0 * E + i] = outs[i];\n"
             "  unsigned long long gt1;\n" + _GLOBALTIMER.format(1)
             + "  if (blockIdx.x == 0 && tid == 0) {\n"
             "    nerf_probe_stamp_buf[0] = k1 - k0;\n    nerf_probe_stamp_buf[1] = k2 - k1;\n"
             "    nerf_probe_stamp_buf[2] = clock64() - k2;\n"
             "    nerf_probe_stamp_buf[3] = (long long)(gt1 - gt0);\n  }\n}\n"),
        ]}),
}


def cut_source(library: str, edits) -> str:
    """The library's source with ``edits`` applied (and, for a stamped copy,
    the stamps' C function appended); each edited string must occur once."""
    src = (kl.CSRC_DIR / kl.KERNEL_SOURCES[library]).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"{library}: the cut's text occurs {src.count(old)} times: {old!r}")
        src = src.replace(old, new)
    return src + (_STAMP_READ if "nerf_probe_stamp_buf" in src else "")


def build_cuts(probe: str) -> dict:
    """Every cut of ``probe`` built together, each in a copy of ``csrc/``:
    ``{cut: ctypes library}``."""
    library, cuts = CUTS[probe]
    procs = {}
    for cut, edits in cuts.items():
        csrc = OUT_DIR / f"{probe}_{cut}"
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(kl.CSRC_DIR, csrc)
        src = csrc / kl.KERNEL_SOURCES[library]
        src.write_text(cut_source(library, edits))
        out = csrc / f"lib{library}.so"
        procs[cut] = (subprocess.Popen([kl._nvcc(), *kl.NVCC_FLAGS, "-o", str(out), str(src)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), out)
    libs = {}
    for cut, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {probe} {cut}:\n{log}")
        libs[cut] = kl.open_library(library, out)
    return libs


def _through(library: str, lib, call):
    """``call`` with the wrappers of ``library`` launching ``lib``."""
    def run():
        kl.use_library(library, lib)
        return call()
    return run


def _ms(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _device_us(fn, kernel: str, calls: int):
    """Device µs a launch of the kernels named ``kernel`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hits = [a for a in prof.key_averages()
            if str(a.device_type).endswith("CUDA") and kernel in a.key]
    total = sum(getattr(a, "self_device_time_total", 0.0) for a in hits)
    count = sum(a.count for a in hits)
    return total / count if count and total > 0 else None


def compare(library: str, kernel: str, runs: dict, calls: int) -> dict:
    """ms a call of each build in turns (in order, then in reverse), and
    device µs a launch of ``kernel``."""
    passes = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            passes[k].append(_ms(runs[k], calls))
    out = {"ms_in_turns": {k: sum(v) / 2 for k, v in passes.items()}, "ms_passes": passes,
           "device_us": {k: _device_us(fn, kernel, calls) for k, fn in runs.items()}}
    kl.use_library(library, None)
    return out


def stamps(lib, call) -> list:
    """The stamped build's four stamps after one call."""
    call()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 4)()
    rc = lib.nerf_probe_stamps(buf)
    if rc != 0:
        raise RuntimeError(f"reading the stamps failed: CUDA error {rc}")
    return list(buf)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", type=Path, default=None, help="also append the JSON lines here")
    p.add_argument("--calls", type=int, default=50, help="calls a pass, and under the profiler")
    p.add_argument("--p1-cases", nargs="+", default=list(P1_CASES), metavar="M:depth:chains")
    args = p.parse_args(argv)
    device = resolve_device(None)
    card = torch.cuda.get_device_name(device)

    def emit(rec):
        line = json.dumps({"card": card, **rec})
        print(line, flush=True)
        if args.out is not None:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    gen = torch.Generator(device=device).manual_seed(SEED)
    w = torch.randn((pk.MXU_WIDTH, pk.MXU_WIDTH), generator=gen, device=device).to(torch.bfloat16)
    port, cuts = kl.load("probe_mma"), build_cuts("P1")
    for case in args.p1_cases:
        m, depth, chains = (int(v) for v in case.split(":"))
        call = lambda: pk.mxu_chain(w, m, depth, chains)  # noqa: E731
        runs = {name: _through("probe_mma", lib, call) for name, lib in
                {"port": port, **{k: v for k, v in cuts.items() if k != "stamped"}}.items()}
        emit({"probe": "P1", "case": case, **compare("probe_mma", "mma_chain_kernel", runs,
                                                    args.calls)})
    cycles, ns = stamps(cuts["stamped"], _through("probe_mma", cuts["stamped"],
                                                  lambda: pk.mxu_chain(w, 2048, 32, 1)))[:2]
    kl.use_library("probe_mma", None)
    emit({"probe": "P1", "case": "2048:32:1", "stamps_block_0": {
        "cycles": cycles, "ns": ns, "ghz": cycles / ns}})

    r_t, n_s, n_tiles = 64, 64, 16  # exp_expand's defaults
    px, py, pz = (torch.randn((n_tiles * n_s, r_t), generator=gen, device=device)
                  for _ in range(3))
    vc = torch.randn((n_tiles * r_t, 3), generator=gen, device=device)
    sc = torch.randn((6, N_THETA), generator=gen, device=device)
    gx = torch.randn((N_THETA, N_ENC), generator=gen, device=device)
    call = lambda: pk.expand_c(px, py, pz, vc, sc, gx)  # noqa: E731
    port, cuts = kl.load("probe_expand"), build_cuts("P6")
    runs = {name: _through("probe_expand", lib, call) for name, lib in
            {"port": port, **{k: v for k, v in cuts.items() if k != "stamped"}}.items()}
    emit({"probe": "P6", "case": f"{n_tiles}x{n_s}x{r_t}",
          **compare("probe_expand", "expand_c_kernel", runs, args.calls)})
    pro, loop, write, ns = stamps(cuts["stamped"], _through("probe_expand", cuts["stamped"], call))
    kl.use_library("probe_expand", None)
    emit({"probe": "P6", "stamps_block_0": {"prologue_cycles": pro, "loop_cycles": loop,
                                            "write_cycles": write, "ns": ns,
                                            "ghz": (pro + loop + write) / ns}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
