"""CLI entry point: run one or more YAML configs end to end.

Port of ``nerf_and_dietnerf_tpu/main.py``, with the same flags; ``--platform``
picks ``cpu`` or ``gpu`` (the default: the GPU, and without one the run
fails). Multi-GPU runs (``--data-devices`` > 1, ``--distributed``) are not
ported yet and fail loudly.

Usage::

    python -m nerf_and_dietnerf_tpu_torch.main config_files/50px_alexander.yaml \
        [more.yaml ...] [--vit-weights vit_b32.npz] [--save-root Results] \
        [--platform cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
import traceback


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("configs", nargs="+", help="YAML run configs (reference schema)")
    p.add_argument("--save-root", default=None, help="override general_save_location")
    p.add_argument(
        "--vit-weights", default=None,
        help="path to public ViT-B/32 weights for DietNeRF (npz/safetensors/bin)",
    )
    p.add_argument(
        "--data-devices", type=int, default=None,
        help="devices on the data-parallel axis (multi-GPU runs are not ported yet)",
    )
    p.add_argument(
        "--distributed", action="store_true",
        help="multi-process runs (not ported yet)",
    )
    p.add_argument(
        "--trace-dir", default=None,
        help="capture a torch.profiler trace of each run into this directory",
    )
    p.add_argument(
        "--nan-checks", action="store_true",
        help="enable autograd anomaly detection (debug mode; slower)",
    )
    p.add_argument(
        "--platform", default=None, choices=("cpu", "gpu"),
        help="where to train and render (default: the GPU)",
    )
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    from nerf_and_dietnerf_tpu_torch.tasks.runner import Runner
    from nerf_and_dietnerf_tpu_torch.utils import profiling

    if args.nan_checks:
        profiling.enable_nan_checks()
    device = "cpu" if args.platform == "cpu" else None

    for config_path in args.configs:
        print(f"=== {config_path} ===")
        start = time.time()
        try:
            if args.distributed:
                raise NotImplementedError(
                    "--distributed: multi-process runs (ROADMAP A10) are not ported to "
                    "PyTorch yet")
            if args.data_devices is not None and args.data_devices > 1:
                raise NotImplementedError(
                    f"--data-devices {args.data_devices}: multi-GPU runs (ROADMAP A10) are "
                    "not ported to PyTorch yet")
            trace_ctx = (
                profiling.trace(args.trace_dir)
                if args.trace_dir
                else contextlib.nullcontext()
            )
            with trace_ctx:
                Runner(
                    config_path, vit_weights=args.vit_weights,
                    save_root=args.save_root, device=device,
                ).start()
        except Exception:
            traceback.print_exc()
            return 1
        print(f"Done with {config_path}. Took {time.time() - start:.5g} seconds.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
