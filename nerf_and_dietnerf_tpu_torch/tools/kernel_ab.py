#!/usr/bin/env python
"""A parent checkout's kernels against this checkout's, in turns on the card.

Builds the libraries of B1 (``mlp_fwd``), B2 (``mlp_bwd``) and B6
(``raymarch_fwd``, ``raymarch_bwd``) of both checkouts, each afresh into its
own ``build/kernel_ab/`` and all at the same time (``sass_diff.build_checkouts``,
``kernel_lib.build_kernels``), and makes the port's wrappers launch one side's
or the other's (``kernel_lib.use_library``). Then, in turns that alternate
parent / change and start with each in turn (parent, change, change, parent,
...), it times at the training step's shapes (the coarse pass's 262,144 rows
and the fine pass's 524,288; 4096 rays of 64 and 128 samples):

- bf16 B1, B2, B6's forward and B6's backward;
- f32 B1 and B2, as controls;
- one bf16 ``pallas`` and one bf16 ``pallas_rm`` training step (flagship
  widths, random weights from a seed, the same draws every call).

Beside each kernel it gives each side's normwise distance to the f64
evaluation of the kernel's chain (``tools/chain.py``: the plain version with
``work=torch.float64``, the same roundings to the compute type, f64 products
and sums) and the plain f32 version's, and each side's registers and spill
bytes (``-Xptxas -v``) and HMMA / HGMMA count (``cuobjdump -sass``).

Unpack the parent into a directory that ``.gitignore`` lists, then run from
this checkout's root on the machine with the card:

    git archive <parent> nerf_and_dietnerf_tpu_torch | tar -x -C build/parent
    python -m nerf_and_dietnerf_tpu_torch.tools.kernel_ab build/parent --out build/kernel_ab.json

It assumes both sides' libraries export the same C functions. It needs the
card and exits 2 without one: there is no CPU version of what it measures.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl
from nerf_and_dietnerf_tpu_torch.tools import SEED, chain, sass_diff

SIDES = ("parent", "change")
LIBS = ("mlp_fwd", "mlp_bwd", "raymarch_fwd", "raymarch_bwd")
ROWS = (4096 * 64, 4096 * 128)  # the coarse and the fine pass of a step
RAYS, SAMPLES = 4096, (64, 128)
TURNS, CALLS = 10, 5  # turns of both sides; calls a side a turn


def turn_order(turns: int) -> list:
    """The sides of each turn: parent first in the even turns, change first
    in the odd ones."""
    return [SIDES if i % 2 == 0 else SIDES[::-1] for i in range(turns)]


def run_turns(cases: dict, turns: int, swap, time_case) -> dict:
    """``{case: {side: [ms of each turn]}}``: every case of ``cases``
    (``{name: callable}``) timed by ``time_case(callable)`` once a side a
    turn, each side's libraries put in place by ``swap(side)`` first."""
    times = {case: {side: [] for side in SIDES} for case in cases}
    for order in turn_order(turns):
        for case, fn in cases.items():
            for side in order:
                swap(side)
                times[case][side].append(time_case(fn))
    return times


def report(times: dict, distances: dict, sass: dict, card: str) -> dict:
    """The JSON report: each case's median ms a call of each side over the
    turns, their ratio (change over parent) and the turns themselves; each
    kernel's distances to the f64 chain; each side's registers and spills."""
    cases = {}
    for case, by_side in times.items():
        med = {side: statistics.median(by_side[side]) for side in SIDES}
        cases[case] = {"parent_ms": med["parent"], "change_ms": med["change"],
                       "change_over_parent": med["change"] / med["parent"],
                       "turns_ms": by_side}
    return {"card": card, "turns": len(next(iter(times.values()))["parent"]) if times else 0,
            "cases": cases, "vs_f64_chain": distances, "sass": sass}


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


def _mlp_inputs(cfg, cd, n, gen, dev):
    """Encodings of points in [-1, 1]^3 and of random view directions, and a
    positive cotangent (so the weight gradients do not cancel)."""
    from nerf_and_dietnerf_tpu_torch.core import encoding

    pts = torch.rand((n, 3), generator=gen, device=dev) * 2 - 1
    x = encoding.encode_xyz(pts, cfg.n_freq_xyz).to(cd).contiguous()
    dirs = torch.randn((n, cfg.n_angles + 1), generator=gen, device=dev)
    d = encoding.encode_view_dirs(dirs, cfg.n_freq_dir).to(cd).contiguous()
    g = (0.5 + torch.rand((n, 4), generator=gen, device=dev)).contiguous()
    return x, d, g


def _ray_inputs(cfg, n_samples, gen, dev):
    """Rays from a radius-4 sphere towards its centre, sorted z in [2, 6],
    a positive raw cotangent."""
    from nerf_and_dietnerf_tpu_torch.core import cameras
    from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk

    o = torch.randn((RAYS, 3), generator=gen, device=dev)
    o = 4 * o / o.norm(dim=1, keepdim=True)
    d = -o / 4 + 0.3 * torch.randn((RAYS, 3), generator=gen, device=dev)
    vc = cameras.view_direction_components(d, cfg.n_angles)
    z = torch.sort(2 + 4 * torch.rand((RAYS, n_samples), generator=gen, device=dev),
                   dim=1).values.contiguous()
    g = 0.5 + torch.rand((RAYS, n_samples, 4), generator=gen, device=dev)
    return rk.pack_rays(cfg, o, d, vc), z, g


def _weights(cfg, cd, dev):
    from nerf_and_dietnerf_tpu_torch.models import mlp
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc

    params = mlp.init_params(torch.Generator().manual_seed(SEED), cfg, device=dev)
    return rc.flatten_params(params, cfg, cd)


def _step(backend: str, dev):
    """One bf16 training step of ``backend`` at the flagship widths and
    batch, from one state and with the same draws every call."""
    from nerf_and_dietnerf_tpu_torch.models import nerf
    from nerf_and_dietnerf_tpu_torch.train import train_step as ts

    config = nerf.NeRFConfig(backend=backend, compute_dtype=torch.bfloat16)
    opt = ts.make_optimizer_with_schedule(5e-4)
    state = ts.init_train_state(torch.Generator().manual_seed(SEED), config, opt, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    o = torch.randn((RAYS, 3), generator=gen, device=dev)
    o = 4 * o / o.norm(dim=1, keepdim=True)
    d = -o / 4 + 0.3 * torch.randn((RAYS, 3), generator=gen, device=dev)
    batch = (o, d / d.norm(dim=1, keepdim=True), torch.rand((RAYS, 3), generator=gen, device=dev))

    def step():
        key = torch.Generator(device=dev).manual_seed(SEED)
        return ts.train_step(state, key, batch, config=config, optimizer=opt)
    return step


def _cases(dev, calls: int) -> dict:
    """``{name: callable}`` of every timed case; each call times ``calls``
    launches (or steps) and returns ms a call."""
    from nerf_and_dietnerf_tpu_torch.models import mlp
    from nerf_and_dietnerf_tpu_torch.ops import raymarch_cuda as rc
    from nerf_and_dietnerf_tpu_torch.ops import research_kernels_cuda as rk

    cfg = mlp.MLPConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = {}
    for cd, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        ws, bs = _weights(cfg, cd, dev)
        for n in ROWS:
            x, d, g = _mlp_inputs(cfg, cd, n, gen, dev)
            cases[f"B1 {name} N={n}"] = (
                lambda ws=ws, bs=bs, x=x, d=d, cd=cd: rc.mlp_fwd(ws, bs, cfg, x, d, cd))
            cases[f"B2 {name} N={n}"] = (
                lambda ws=ws, bs=bs, x=x, d=d, g=g, cd=cd: rc.mlp_bwd(ws, bs, cfg, x, d, g, cd))
    ws, bs = _weights(cfg, torch.bfloat16, dev)
    for s in SAMPLES:
        rd, z, g = _ray_inputs(cfg, s, gen, dev)
        cases[f"B6 fwd bf16 S={s}"] = (
            lambda rd=rd, z=z: rk.raymarch_fwd(ws, bs, cfg, rd, z, torch.bfloat16))
        cases[f"B6 bwd bf16 S={s}"] = (
            lambda rd=rd, z=z, g=g: rk.raymarch_bwd(ws, bs, cfg, rd, z, g, torch.bfloat16))
    for backend in ("pallas", "pallas_rm"):
        cases[f"step {backend} bf16"] = _step(backend, dev)
    return {name: (lambda fn=fn: _ms(fn, calls)) for name, fn in cases.items()}


def _chains(dev) -> dict:
    """``{name: tools.chain.Chain}`` of every kernel whose distance to the
    f64 chain the report gives: B1 and B2 in both types, bf16 B6."""
    from nerf_and_dietnerf_tpu_torch.models import mlp

    cfg = mlp.MLPConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    out = {}
    for cd, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        ws, bs = _weights(cfg, cd, dev)
        x, d, g = _mlp_inputs(cfg, cd, ROWS[0], gen, dev)
        out[f"B1 {name} N={ROWS[0]}"] = chain.forward_chain(ws, bs, cfg, x, d, cd)
        out[f"B2 {name} N={ROWS[0]}"] = chain.mlp_chain(ws, bs, cfg, x, d, g, cd)
    ws, bs = _weights(cfg, torch.bfloat16, dev)
    for s in SAMPLES:
        rd, z, g = _ray_inputs(cfg, s, gen, dev)
        out[f"B6 bf16 S={s}"] = chain.ray_chain(ws, bs, cfg, rd, z, g, torch.bfloat16)
    return out


def side_distances(chains: dict, swap) -> dict:
    """``{kernel: {output: {"plain": d, "parent": d, "change": d,
    "ratio_<side>_to_plain": r}}}`` (``tools.chain.distances``), each side's
    libraries put in place by ``swap(side)``; one kernel at a time, so only
    its tensors are held."""
    out = {}
    for name, c in chains.items():
        out[name] = chain.distances(c, {side: (lambda side=side, c=c: (swap(side), c.kernel())[1])
                                        for side in SIDES})
        torch.cuda.empty_cache()
    return out


def sass_report(builds: dict) -> dict:
    """``{side: {library: {kernel: {registers, spill_stores, spill_loads,
    HMMA, HGMMA}}}}`` of both builds (the counts where ``cuobjdump`` is
    installed)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for side, build in builds.items():
        blocks = sass_diff.ptxas_blocks(build["log"])
        for lib in LIBS:
            entries = sass_diff.ptxas_entries(blocks.get(lib, []))
            if Path(tool).exists():
                funcs = sass_diff.sass_functions(subprocess.run(
                    [tool, "-sass", build["paths"][lib]], check=True, capture_output=True,
                    text=True).stdout)
                for fname, instructions in funcs.items():
                    if fname in entries:
                        entries[fname].update({op: sum(len(re.findall(rf"\b{op}\b", i))
                                                       for i in instructions)
                                               for op in ("HMMA", "HGMMA")})
            out.setdefault(side, {})[lib] = entries
    return out


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(0) + ", power limit not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("parent", type=Path,
                   help="a parent checkout (holding nerf_and_dietnerf_tpu_torch/)")
    p.add_argument("--out", type=Path, help="write the JSON report here too")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab needs a CUDA card (torch.cuda.is_available() is false): it times "
              "the kernels on it and has no CPU version", file=sys.stderr)
        return 2
    if not (args.parent / "nerf_and_dietnerf_tpu_torch" / "csrc").is_dir():
        print(f"{args.parent} holds no nerf_and_dietnerf_tpu_torch/csrc/", file=sys.stderr)
        return 2
    here = Path(kl.__file__).resolve().parents[2]
    builds = sass_diff.build_checkouts({"parent": args.parent, "change": here}, "kernel_ab",
                                       LIBS)
    libs = {side: {name: kl.open_library(name, Path(builds[side]["paths"][name]))
                   for name in LIBS} for side in SIDES}

    def swap(side):
        for name in LIBS:
            kl.use_library(name, libs[side][name])

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    try:
        sass = sass_report(builds)
        print(f"registers, spills, HMMA / HGMMA: {json.dumps(sass)}", flush=True)
        distances = side_distances(_chains(dev), swap)
        for name, rec in distances.items():
            print(f"{name} against the f64 chain (normwise): {json.dumps(rec)}", flush=True)
        times = run_turns(_cases(dev, CALLS), TURNS, swap, lambda fn: fn())
    finally:
        for name in LIBS:
            kl.use_library(name, None)
    rep = report(times, distances, sass, card)
    for case, r in rep["cases"].items():
        print(f"{case}: parent {r['parent_ms']:.4f} ms, change {r['change_ms']:.4f} ms "
              f"({r['change_over_parent']:.4f}x; medians of {rep['turns']} turns, "
              f"{CALLS} calls each)", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rep, indent=1))
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
