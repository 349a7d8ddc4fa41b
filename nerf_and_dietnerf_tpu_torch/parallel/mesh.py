"""The data-parallel group: one process per device over ``torch.distributed``.

Port of ``nerf_and_dietnerf_tpu/parallel/mesh.py``. JAX's one-axis ``("data",)``
mesh becomes a :class:`DataGroup`: this process's rank, the world size, its
device and the process group. The ray batch is split over the ranks, each
rank holding rows ``[rank * B / W, (rank + 1) * B / W)`` of every global batch
(:func:`batch_rows` and :func:`batch_indices`, the port of ``batch_sharding``
/ ``shard_batch`` / ``make_global_batch``). Parameters and Adam state are
replicated: every rank holds its own copy, so JAX's ``replicated`` sharding
has no counterpart, and every rank applies the same update to it because the
gradient is averaged over the ranks by one all-reduce of one flat buffer a
step (:func:`all_reduce_mean_`), where JAX's ``psum`` follows each kernel.

Only ``all_reduce``, ``broadcast``, ``broadcast_object_list`` and ``barrier``
are used, so the same code runs under NCCL, and under gloo on CPU tensors or
on CUDA tensors (two ranks sharing one GPU).
"""

from __future__ import annotations

import dataclasses
import os
import socket
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This process's place in the data-parallel group.

    :param rank / world_size: of the process group.
    :param device: the device this rank trains and renders on.
    :param group: the ``ProcessGroup`` (None: the default group).
    :param buffers: reduction buffers kept across calls, by their key
        (``parallel/render_tiles`` keeps its frame buffer here).
    """

    rank: int
    world_size: int
    device: torch.device
    group: Any = None
    buffers: Dict[Any, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)


def init_distributed(device=None, backend: Optional[str] = None) -> torch.device:
    """Join the default process group from torch's launcher variables
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``: what ``torchrun`` sets), the counterpart of the JAX
    package's ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``.

    :param device: this rank's device; default ``cuda:LOCAL_RANK``.
    :param backend: default ``nccl`` on a CUDA device, ``gloo`` on the CPU;
        ``gloo`` also takes CUDA tensors (ranks sharing one GPU). A backend
        that cannot initialise raises: there is no fallback to another.
    :return: the device.
    """
    rank = int(os.environ["RANK"])
    world_size = int(os.environ["WORLD_SIZE"])
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world_size)
    return device


def make_mesh(device) -> Optional[DataGroup]:
    """The default process group as a :class:`DataGroup` on ``device``; None
    when no group is initialised or it holds one process (the JAX package's
    ``main.py`` builds no mesh over one device either), so a one-process run
    takes the single-device code."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return DataGroup(rank=dist.get_rank(), world_size=dist.get_world_size(),
                     device=torch.device(device), group=dist.group.WORLD)


def batch_rows(batch_size: int, rank: int = 0, world_size: int = 1) -> Tuple[int, int]:
    """``(lo, hi)``: rank ``rank``'s rows of a global batch of ``batch_size``
    split over ``world_size`` ranks."""
    if batch_size % world_size:
        raise ValueError("batch_size must divide evenly across hosts")
    per = batch_size // world_size
    return rank * per, (rank + 1) * per


def batch_indices(perm: torch.Tensor, b: int, batch_size: int, rank: int = 0,
                  world_size: int = 1) -> torch.Tensor:
    """Rank ``rank``'s rows of batch ``b`` of the permutation ``perm``, as the
    JAX package's ``RayDataset.epoch`` shards it: the one slicer of the
    training batches (``train_step.run_epoch``, ``data/pipeline.RayDataset``)."""
    lo, hi = batch_rows(batch_size, rank, world_size)
    return perm[b * batch_size:(b + 1) * batch_size][lo:hi]


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: DataGroup) -> List[torch.Tensor]:
    """Average ``tensors`` (one dtype, one device) over the ranks in place:
    one ``all_reduce`` (sum) of one flat buffer holding all of them, then a
    divide by the world size. Every rank gets the same bits."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.world_size
    out, at = [], 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
        out.append(t)
    return out


def all_reduce_sum_(tensor: torch.Tensor, mesh: DataGroup) -> torch.Tensor:
    """Sum ``tensor`` over the ranks in place."""
    dist.all_reduce(tensor, group=mesh.group)
    return tensor


def broadcast_object(obj, mesh: DataGroup, src: int = 0):
    """``obj`` of rank ``src`` on every rank (a picklable object)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=mesh.group)
    return box[0]


def barrier(mesh: DataGroup) -> None:
    dist.barrier(group=mesh.group)


# --------------------------------------------------------------------------- #
# One host's ranks, spawned                                                    #
# --------------------------------------------------------------------------- #

def free_port() -> int:
    """A free TCP port on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, fn: Callable, devices: Sequence[str], port: int,
                backend: Optional[str], args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(len(devices)), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if torch.device(devices[rank]).type == "cpu":
        # CPU ranks share the host's cores: with a full thread pool each, their
        # OpenMP threads spin against each other (30x slower steps, measured).
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    device = init_distributed(devices[rank], backend)
    try:
        fn(rank, make_mesh(device), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, devices: Sequence[str], args: tuple = (),
          backend: Optional[str] = None, timeout: float = 600.0) -> None:
    """Run ``fn(rank, mesh, *args)`` in ``len(devices)`` spawned processes,
    rank ``r`` on ``devices[r]``, joined in one process group on a free
    127.0.0.1 port (``backend`` as :func:`init_distributed` picks it). ``fn``
    must be importable by name. Raises if any rank fails (the others are
    terminated) or if the ranks have not all ended within ``timeout``
    seconds (then all are killed)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_entry, args=(fn, list(devices), free_port(), backend, args),
                             nprocs=len(devices), join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{len(devices)} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
