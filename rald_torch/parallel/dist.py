"""Multi-process runtime on ``torch.distributed``: the port's counterpart of
``rald_tpu/parallel/mesh.py``.

One process per card, as the reference ran DDP (``utils/misc.py:214-246``):

- :func:`init_distributed` keeps JAX's order of discovery (``mesh.py:52-73``):
  ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
  first, then torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` (default 12355) /
  ``WORLD_SIZE`` / ``RANK``. ``LOCAL_RANK`` picks ``cuda:{LOCAL_RANK}``. The
  backend is NCCL for a CUDA device and gloo for the CPU. A single process
  needs nothing and never builds a process group; a configured rendezvous
  that fails raises, and ``WORLD_SIZE`` above 1 with no address raises,
  naming the variable: no rank runs alone.
- :func:`all_reduce_mean_` replaces the ``psum`` XLA inserts for a sharded
  batch under ``jit``: the trainers average their gradients (and the step's
  metrics) across ranks in one collective a step.
- :func:`draw_rows` gives a rank its rows of a draw made at the global
  batch, as a jitted JAX step draws at the global shape and shards it.
- :func:`all_gather_rows` and :func:`broadcast_` carry
  ``eval.inference.shard_queries`` (JAX's ``shard_map`` of the decode over
  its query axis, ``gen_engine.py:637-650``): rank 0's tokens go to every
  rank, each rank decodes its part of the queries, the parts are gathered.

``make_mesh``, ``shard_batch``, ``replicated`` and
``enable_compilation_cache`` have no counterpart: each process holds its
own card, its own batch rows (``ShardedSampler``) and a full copy of the
params (kept equal by the averaged gradients), and there is no XLA
compilation cache to keep.
"""
from __future__ import annotations

import datetime
import inspect
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_PORT = "12355"
TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(*names: str, default: str = "0") -> int:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return int(default)


def rendezvous() -> tuple:
    """``(init_method or None, world_size, rank)`` from the environment, in
    JAX's order: ``JAX_COORDINATOR_ADDRESS`` with ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` (each falling back to torchrun's ``WORLD_SIZE`` /
    ``RANK``), else ``MASTER_ADDR`` / ``MASTER_PORT`` with ``WORLD_SIZE`` /
    ``RANK``, which needs ``WORLD_SIZE`` set. No address: one process, and
    ``WORLD_SIZE`` above 1 raises ``RuntimeError`` naming ``MASTER_ADDR``.
    An address with a world of 1 is a group of one (``torchrun
    --nproc_per_node=1`` runs so)."""
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    world = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE", default="1")
    rank = _env_int("JAX_PROCESS_ID", "RANK")
    if coord is None and os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        coord = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT') or DEFAULT_PORT}"
        world, rank = _env_int("WORLD_SIZE", default="1"), _env_int("RANK")
    if coord is None:
        if world > 1:
            raise RuntimeError(
                f"rald_torch.parallel: WORLD_SIZE={world} but no rendezvous address: set "
                "MASTER_ADDR (and MASTER_PORT, default 12355) as torchrun does, or "
                "JAX_COORDINATOR_ADDRESS")
        return None, 1, 0
    if not 0 <= rank < world:
        raise RuntimeError(f"rald_torch.parallel: RANK={rank} outside WORLD_SIZE={world}")
    return f"tcp://{coord}", world, rank


def local_device(device=None) -> torch.device:
    """The device of this process: ``device`` where given, else
    ``cuda:{LOCAL_RANK}`` (``cuda:0`` without ``LOCAL_RANK``)."""
    if device is not None:
        return torch.device(device)
    return torch.device(f"cuda:{_env_int('LOCAL_RANK')}")


def init_distributed(device=None, backend: Optional[str] = None) -> dict:
    """Join the process group the environment describes (see
    :func:`rendezvous`) and return :func:`process_info`. ``device`` (see
    :func:`local_device`) picks the backend, NCCL on a CUDA device and gloo
    on the CPU, unless ``backend`` names one (two ranks that share one card
    use gloo: NCCL refuses a duplicated device). A CUDA device becomes the
    current device. :data:`TIMEOUT` bounds the rendezvous and every
    collective: a rank that cannot reach the others raises. Idempotent;
    without a rendezvous nothing happens."""
    if dist.is_initialized():
        return process_info()
    init_method, world, rank = rendezvous()
    if init_method is None:
        return process_info()
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if backend == "nccl" and "device_id" in inspect.signature(dist.init_process_group).parameters:
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=TIMEOUT, **kw)
    return process_info()


def world_rank() -> tuple:
    """``(world_size, rank)``: ``(1, 0)`` without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def process_info() -> dict:
    """JAX's keys (``mesh.py:76-83``): one device per process."""
    world, rank = world_rank()
    return {"rank": rank, "world_size": world, "is_main_process": rank == 0,
            "local_device_count": 1, "global_device_count": world}


def is_main_process() -> bool:
    return world_rank()[1] == 0


def backend() -> Optional[str]:
    """The process group's backend, or None without one."""
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def barrier() -> None:
    if backend() is not None:
        dist.barrier()


def destroy() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _comm_device(t: torch.Tensor) -> torch.device:
    """NCCL reduces CUDA tensors only; gloo takes either."""
    if backend() == "nccl" and t.device.type != "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place: one float32
    buffer of them all, one SUM all-reduce, a division by the world size,
    and each tensor copied back in its own dtype. Every rank ends with the
    same values, bitwise; in a group of one the values stay as they were.
    A no-op without a process group."""
    if backend() is None or not tensors:
        return
    world = world_rank()[0]
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    buf = flat.to(_comm_device(flat))
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    buf = (buf / world).to(flat.device)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(buf[offset:offset + n].view_as(t))
        offset += n


@torch.no_grad()
def all_reduce_sum(values: Sequence[float]) -> list:
    """Host numbers summed over the ranks in float64 (one collective); the
    values themselves without a process group."""
    if backend() is None:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    buf = t.to(_comm_device(t))
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.cpu().tolist()


@torch.no_grad()
def broadcast_(t: torch.Tensor) -> torch.Tensor:
    """``t`` overwritten in place with rank 0's tensor of the same shape and
    dtype, and returned; the bytes are rank 0's on every rank. A no-op
    without a process group."""
    if backend() is None:
        return t
    buf = t.to(_comm_device(t))
    dist.broadcast(buf, src=0)
    if buf is not t:
        t.copy_(buf)
    return t


@torch.no_grad()
def all_gather_rows(t: torch.Tensor, length: int, dim: int = 1) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order, each
    rank's part zero-padded at its end to ``length`` first (``t`` is at
    most ``length`` long on ``dim``; its other dims are the same on every
    rank): ``world * length`` long on ``dim``, the same on every rank, each
    part's bytes unchanged (the parts travel as bytes, whatever their
    dtype). The caller trims the padding. Without a process group: ``t``
    padded to ``length``."""
    pad = length - t.shape[dim]
    if pad < 0:
        raise ValueError(f"all_gather_rows: {t.shape[dim]} rows on dim {dim} > length {length}")
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        t = torch.cat([t, t.new_zeros(shape)], dim)
    if backend() is None:
        return t
    part = t.movedim(dim, 0).contiguous()
    buf = part.reshape(-1).view(torch.uint8).to(_comm_device(part))
    parts = [torch.empty_like(buf) for _ in range(world_rank()[0])]
    dist.all_gather(parts, buf)
    out = torch.cat(parts).to(t.device).view(t.dtype)
    return out.reshape((-1,) + part.shape[1:]).movedim(0, dim)


def draw_rows(draw, shape, **kw) -> torch.Tensor:
    """This rank's rows of ``draw(global shape, **kw)``: the draw is made at
    ``world * shape[0]`` rows and rank ``r`` keeps rows ``r * shape[0]`` to
    ``(r + 1) * shape[0]``, as a jitted JAX step draws at the global batch
    and shards it. So every rank draws from the same generator state and a
    world-N step sees the draws of a one-process step on the ranks' rows
    concatenated; no two ranks share a row. In one process: ``draw(shape)``."""
    world, rank = world_rank()
    shape = tuple(shape)
    if world == 1:
        return draw(shape, **kw)
    n = shape[0]
    return draw((world * n,) + shape[1:], **kw)[rank * n:(rank + 1) * n]
