"""CLI entry point: run one or more YAML configs end to end.

Port of ``nerf_and_dietnerf_tpu/main.py``, with the same flags; ``--platform``
picks ``cpu`` or ``gpu`` (the default: the GPU, and without one the run
fails).

Data parallelism (``parallel/mesh.py``), one process a device:

- ``--distributed``: this process is one rank of a group started by a
  launcher, ``torchrun`` or another that sets ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` (NCCL on the GPU, gloo
  with ``--platform cpu``);
- otherwise ``main`` spawns the ranks itself: ``--data-devices N`` GPUs (at
  most those visible; all of them without the flag), or N gloo CPU ranks with
  ``--platform cpu`` (1 without the flag). When that comes to one device, a
  config's ``mesh: data_devices`` is used the same way. One rank runs in this
  process, with no group.

Usage::

    python -m nerf_and_dietnerf_tpu_torch.main config_files/50px_alexander.yaml \
        [more.yaml ...] [--vit-weights vit_b32.npz] [--save-root Results] \
        [--platform cpu] [--data-devices N]
    torchrun --nproc-per-node 4 -m nerf_and_dietnerf_tpu_torch.main cfg.yaml --distributed
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
        help="devices of the data-parallel group (default: every visible GPU; 1 on the CPU)",
    )
    p.add_argument(
        "--distributed", action="store_true",
        help="join the process group of a launcher (torchrun's RANK / WORLD_SIZE / "
        "MASTER_ADDR / MASTER_PORT variables)",
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


def _world_size(args, config_path) -> int:
    """The ranks ``main`` spawns for a config: ``--data-devices`` (at most the
    visible GPUs), else every visible GPU (1 on the CPU); a config's
    ``mesh: data_devices`` when that comes to one."""
    import torch

    available = None if args.platform == "cpu" else torch.cuda.device_count()

    def capped(n: int) -> int:
        return n if available is None else max(1, min(n, available))

    if args.data_devices is not None:
        world = capped(args.data_devices)
        asked = args.data_devices
    else:
        world = 1 if available is None else max(1, available)
        asked = None
    if world == 1:
        from nerf_and_dietnerf_tpu_torch.utils import config as config_lib

        asked = config_lib.load_config(config_path).mesh_data_devices or asked
        if asked and asked > 1:
            world = capped(asked)
    if asked is not None and asked != world:
        print(f"data devices: {world} of {asked} asked")
    return world


def _run_config(config_path, args, device, mesh) -> None:
    from nerf_and_dietnerf_tpu_torch.tasks.runner import Runner
    from nerf_and_dietnerf_tpu_torch.utils import profiling

    if args.nan_checks:
        profiling.enable_nan_checks()
    trace_dir = args.trace_dir
    if trace_dir and mesh is not None:
        trace_dir = f"{trace_dir}/rank{mesh.rank}"
    trace_ctx = profiling.trace(trace_dir) if trace_dir else contextlib.nullcontext()
    with trace_ctx:
        Runner(
            config_path, vit_weights=args.vit_weights, save_root=args.save_root,
            device=device, mesh=mesh,
        ).start()


def _rank_main(rank: int, mesh, config_path, args) -> None:
    """One spawned rank: the config's runner on this rank's device."""
    _run_config(config_path, args, mesh.device, mesh)


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    device = "cpu" if args.platform == "cpu" else None
    mesh = None
    if args.distributed:
        from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib

        try:
            device = mesh_lib.init_distributed(device)
        except Exception:
            traceback.print_exc()
            return 1
        mesh = mesh_lib.make_mesh(device)
        print(f"data devices: {1 if mesh is None else mesh.world_size} (rank "
              f"{0 if mesh is None else mesh.rank})")
    try:
        for config_path in args.configs:
            print(f"=== {config_path} ===")
            start = time.time()
            try:
                world = 1 if args.distributed else _world_size(args, config_path)
                if world > 1:
                    from nerf_and_dietnerf_tpu_torch.parallel import mesh as mesh_lib

                    print(f"data devices: {world} spawned ranks")
                    devices = (["cpu"] * world if args.platform == "cpu"
                               else [f"cuda:{r}" for r in range(world)])
                    mesh_lib.spawn(_rank_main, devices, args=(config_path, args),
                                   timeout=float("inf"))
                else:
                    _run_config(config_path, args, device, mesh)
            except Exception:
                traceback.print_exc()
                return 1
            print(f"Done with {config_path}. Took {time.time() - start:.5g} seconds.")
    finally:
        if args.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
