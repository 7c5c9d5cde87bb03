"""Data parallelism over processes: joining the process group, each rank's
block of the batch, the state broadcast from rank 0, and the gradients' mean.

Port of ``unopticalflow_tpu/parallel/mesh.py``.  JAX drives every device of
a host from one process and shards the batch over a 1-D ``data`` mesh, and
XLA lowers the gradients' ``pmean`` to an all-reduce.  Here **one process
drives one card**, PyTorch's idiom and torchrun's: ``--num_processes``
counts processes and therefore cards, and the process of id p takes
``cuda:{LOCAL_RANK}`` where torchrun sets it, else ``cuda:{p %
device_count}``.  The reference's rule (batch × N, iterations / N) applies
to the global card count, as the JAX rule applies to ``len(jax.devices())``.

The collectives run over ``torch.distributed``: NCCL for CUDA, gloo for the
CPU.  Gloo also takes CUDA tensors (it stages them through the host), which
lets two ranks share one card, where NCCL refuses ("Duplicate GPU
detected"); a gloo collective cannot be recorded in a CUDA graph.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# longer than an interleaved KITTI evaluation, which the other ranks wait out
# at a barrier (the JAX trainer meets gloo's hard 30 s limit there)
DEFAULT_TIMEOUT_S = 3600.0


def process_device(process_id: int) -> torch.device:
    """The card of process ``process_id``: ``cuda:{LOCAL_RANK}`` where the
    launcher sets it, else ``cuda:{process_id % device_count}``.  Raises
    without CUDA: no rank carries on on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("a data-parallel process drives one CUDA card, and CUDA is not "
                           "available (pass --device cpu for a CPU process group)")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else process_id % torch.cuda.device_count()
    return torch.device("cuda", index)


def initialize_multi_host(coordinator_address: str | None = None,
                          num_processes: int | None = None, process_id: int | None = None,
                          backend: str | None = None, device=None,
                          timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the job's process group; returns the device this process drives.

    Wraps ``torch.distributed.init_process_group`` with the init method
    ``tcp://<coordinator_address>`` (an address holding ``://``, such as a
    ``file://`` store, is taken as given).  Arguments left out are read from
    torchrun's environment: ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK`` (the counterpart of JAX's cloud auto-detection); where neither
    gives one, this raises and names what is missing.  ``device``: None or
    ``"cuda"`` takes ``process_device(process_id)``; an explicit device is
    kept.  ``backend`` defaults to ``nccl`` for a CUDA device and ``gloo``
    for the CPU.  A failed init raises; nothing falls back to another
    backend.
    """
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    missing = [name for name, value in (
        ("--coordinator_address (or MASTER_ADDR and MASTER_PORT)", coordinator_address),
        ("--num_processes (or WORLD_SIZE)", num_processes),
        ("--process_id (or RANK)", process_id)) if value is None]
    if missing:
        raise ValueError("--multi_host needs " + ", ".join(missing))
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} is not in [0, {num_processes})")
    device = torch.device(device or "cuda")
    if device.type == "cuda" and device.index is None:
        device = process_device(process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    init = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return device


def data_parallel_world(group=None) -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def shard_batch(batch, rank: int, world: int):
    """Rank ``rank``'s contiguous block of a global batch (an array, a tensor,
    a list of sample indices, or a tuple of them), as JAX's ``data`` mesh
    lays the rows out."""
    if isinstance(batch, tuple):
        return tuple(shard_batch(x, rank, world) for x in batch)
    n = len(batch)
    if n % world:
        raise ValueError(f"global batch {n} must divide over {world} processes")
    b = n // world
    return batch[rank * b:(rank + 1) * b]


def _comm_device(group) -> torch.device | None:
    """Where a collective's buffer must live: the current card under NCCL,
    anywhere under gloo (None)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return None


def _flat_groups(tensors: list[torch.Tensor]):
    """The tensors grouped by (dtype, device), in order."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


def _collect(state) -> list[torch.Tensor]:
    if isinstance(state, torch.nn.Module):
        return list(state.state_dict().values())
    if isinstance(state, torch.optim.Optimizer):
        # the parameters' order, each state's names sorted: the same on every rank
        return [s[name] for g in state.param_groups for p in g["params"]
                if (s := state.state.get(p)) for name in sorted(s) if torch.is_tensor(s[name])]
    return list(state)


@torch.no_grad()
def replicate(state, src: int = 0, group=None) -> None:
    """Broadcast ``state`` from rank ``src`` in place: a module (its
    parameters and buffers), an optimizer (its state tensors, Adam's moments
    and step counts), or tensors.  One broadcast per dtype and device."""
    comm = _comm_device(group)
    for ts in _flat_groups(_collect(state)):
        flat = torch.cat([t.reshape(-1) for t in ts])
        buf = flat.to(comm) if comm is not None else flat
        dist.broadcast(buf, src, group=group)
        for t, v in zip(ts, buf.to(ts[0].device).split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


@torch.no_grad()
def all_reduce_mean(tensors, group=None) -> None:
    """The pmean, in place: one all-reduce (sum) of one flat buffer of the
    tensors, then a division by the world size.  Tensors of another dtype or
    device than the first go in a buffer of their own (the trainer passes
    float32 gradients and metrics: one)."""
    tensors = list(tensors)
    world = dist.get_world_size(group)
    for ts in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))
