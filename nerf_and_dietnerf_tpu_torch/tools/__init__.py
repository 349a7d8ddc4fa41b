"""Tools of the port, the counterparts of the JAX package's ``tools/``.

Probe tools: ``exp_mxu``, ``exp_vpu``, ``exp_interleave``, ``exp_expand`` and
``exp_enccost`` (of ``tools/exp_*.py``), each timing a hand-written CUDA probe
kernel of ``ops/probe_kernels_cuda.py`` on the GPU:

    python -m nerf_and_dietnerf_tpu_torch.tools.exp_mxu
    python -m nerf_and_dietnerf_tpu_torch.tools.exp_mxu --device cpu --cases 64:8:2

Parity and DietNeRF tools: ``parity_gpu`` (of ``tools/parity_tpu.py``: the
fixed-z objective's loss and gradients of every kernel path against an
f64-chain oracle, ``PARITY_GPU.json``), ``train_scene_embedder`` and
``eval_embedder_consistency`` (a small ViT embedder trained on a scene corpus
and written for ``--vit-weights``; its within- and across-scene cosines):

    python -m nerf_and_dietnerf_tpu_torch.tools.parity_gpu --out PARITY_GPU.json
    python -m nerf_and_dietnerf_tpu_torch.tools.train_scene_embedder --out v.npz --scenes A B

Probe profile: ``probe_cuts`` (where P1's and P6's time goes: cut and
``clock64``-stamped copies of their kernels timed in turns against the
port's build; on the card):

    python -m nerf_and_dietnerf_tpu_torch.tools.probe_cuts --out chiprun_out/cuts.jsonl

Build check: ``sass_diff`` (whether a change leaves the compiled kernels'
SASS and ptxas lines as a parent checkout's; on the machine with the CUDA
toolkit):

    python -m nerf_and_dietnerf_tpu_torch.tools.sass_diff build/parent

Parent against change: ``kernel_ab`` (bf16 B1, B2 and B6 with the f32 B1 /
B2 controls and the bf16 ``pallas`` / ``pallas_rm`` steps, a parent
checkout's build and this one's in alternating turns, with each side's
distance to the f64 chain and its registers; on the card):

    python -m nerf_and_dietnerf_tpu_torch.tools.kernel_ab build/parent --out build/kernel_ab.json

Every tool has ``main(argv=None)``; the others run on the GPU unless
``--device cpu`` is given (then the kernel wrappers run their plain PyTorch
versions, and times are the host's). The probe tools print one line per case in the form their
counterparts print, with the H100's peaks where those have the TPU's.
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
