"""Probe tools of the port: the counterparts of the JAX package's
``tools/exp_mxu.py``, ``exp_vpu.py``, ``exp_interleave.py``, ``exp_expand.py``
and ``exp_enccost.py``, each timing a hand-written CUDA probe kernel of
``ops/probe_kernels_cuda.py`` on the GPU:

    python -m nerf_and_dietnerf_tpu_torch.tools.exp_mxu
    python -m nerf_and_dietnerf_tpu_torch.tools.exp_mxu --device cpu --cases 64:8:2

Every tool has ``main(argv=None)``, runs on the GPU unless ``--device cpu`` is
given (then the plain PyTorch versions run, and the times are the host's), and
prints one line per case in the form its counterpart prints, with the H100's
peaks where that one has the TPU's.
"""

from __future__ import annotations

import argparse
import time

import torch


SEED = 0  # of every tool's inputs

# H100 SXM peak (NVIDIA's data sheet): dense bf16 on the tensor cores. Every
# product the tools time has bf16 operands.
PEAK_BF16 = 989e12


def parser(description: str, reps: int) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--reps", type=int, default=reps, help="timed calls per case")
    return p


def seconds_per_call(fn, device: torch.device, reps: int) -> float:
    """One warm-up call, then ``reps`` calls: by CUDA events on the GPU, by the
    host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps / 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def peak_share(flops: float, seconds: float, device: torch.device) -> str:
    """Share of the H100's bf16 tensor-core peak, in percent; a CPU run has none."""
    if device.type != "cuda":
        return "n/a"
    return f"{flops / PEAK_BF16 / seconds * 100:.1f}%"


def note(device: torch.device) -> str:
    """What a line of a CPU run must say about itself."""
    return "" if device.type == "cuda" else "  [cpu: plain version, host clock]"


def mlp_flops(config, n_rows: int) -> int:
    """FLOPs of the radiance MLP's products on ``n_rows`` rows."""
    xyz, hid, last = config.xyz_dim, config.hidden_dim, config.last_hidden_dim
    macs = xyz * hid + 6 * hid * hid + (xyz + hid) * hid
    if config.uses_view_dirs:
        feat = hid + config.dir_dim
        macs += feat * last + last * 3 + feat
    else:
        macs += hid * hid + hid * last + last * 3 + hid
    return 2 * macs * n_rows


def mlp_case(n_rows: int, device: torch.device):
    """The flagship view-dir MLP in bf16 and ``n_rows`` rows of standard
    normal encodings: ``(config, ws, bs, x, d)`` on ``device``."""
    from nerf_and_dietnerf_tpu_torch.models import mlp
    from nerf_and_dietnerf_tpu_torch.ops.raymarch_cuda import flatten_params

    config = mlp.MLPConfig()
    params = mlp.init_params(torch.Generator().manual_seed(SEED), config, device=device)
    ws, bs = flatten_params(params, config, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    x = torch.randn((n_rows, config.xyz_dim), generator=gen, device=device)
    d = torch.randn((n_rows, config.dir_dim), generator=gen, device=device)
    return config, ws, bs, x, d
