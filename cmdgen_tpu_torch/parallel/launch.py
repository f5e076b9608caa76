"""The process group of a parallel run: one process per GPU under
``torchrun``, or a world of one.

``torchrun --nproc-per-node N -m cmdgen_tpu_torch.cli train-diffphar ...``
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address;
rank r then drives ``cuda:LOCAL_RANK``. Outside ``torchrun`` a trainer that
is asked for a mesh or FSDP joins a world of one through an in-process
store. The backend is ``nccl`` on CUDA and ``gloo`` on the CPU.

``spawn(fn, world, ...)`` starts ``world`` fresh processes that join one
group through a ``file://`` init method and returns what ``fn`` returned
on each rank (the multi-process tests use it, on the CPU under gloo).
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from cmdgen_tpu_torch.device import DeviceLike, resolve_device

SPAWN_TIMEOUT_S = 600.0  # the longest a spawned group may run


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the default group, and its device."""

    rank: int
    size: int
    device: torch.device


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_process_group(device: DeviceLike = None, init_method: Optional[str] = None,
                       rank: Optional[int] = None, world_size: Optional[int] = None) -> World:
    """Join the default process group (made here unless it exists).

    Rank and size come from the arguments, else from the group that
    exists, else from ``torchrun``'s environment, else a world of one
    (which needs no ``init_method``).
    On CUDA rank r takes ``cuda:LOCAL_RANK`` (the rank itself where
    ``LOCAL_RANK`` is unset) and makes it the current device."""
    dev = resolve_device(device)
    env = under_torchrun()
    joined = dist.is_initialized()
    if rank is None:
        rank = dist.get_rank() if joined else int(os.environ["RANK"]) if env else 0
    if world_size is None:
        world_size = (dist.get_world_size() if joined
                      else int(os.environ["WORLD_SIZE"]) if env else 1)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if joined:
        if (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
            raise RuntimeError(f"a process group of rank {dist.get_rank()} in "
                               f"{dist.get_world_size()} exists; asked for {rank} in {world_size}")
        return World(rank, world_size, dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if init_method is None and not env:
        if world_size != 1:
            raise ValueError("a world of more than one process needs torchrun or an init_method")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size)
    return World(rank, world_size, dev)


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _child(fn, rank: int, world: int, init_method: str, device: torch.device, args: tuple,
           out) -> None:
    if device.type == "cpu":
        torch.set_num_threads(1)
    try:
        init_process_group(device, init_method, rank, world)
        out.put((rank, True, fn(*args)))
    except BaseException:  # handed to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))
    finally:
        destroy_process_group()


def spawn(fn: Callable[..., Any], world: int, *args, init_method: str,
          device: DeviceLike = None) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` new processes (the ``spawn`` start
    method; ``fn`` must be importable) joined into one group through
    ``init_method`` (e.g. ``file:///path/to/a/new/file``) on ``device``
    (default ``cuda``, rank r on ``cuda:r``; on the CPU each rank runs one
    thread). Returns the ranks' return values in rank order; raises with
    the child's traceback if any rank failed, and after
    ``SPAWN_TIMEOUT_S``."""
    device = resolve_device(device)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, r, world, init_method, device, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    failed = False
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawned ranks did not finish in {SPAWN_TIMEOUT_S} s")
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a spawned rank died with exit code {dead[0]}")
                continue
            if not ok:  # the other ranks may wait on it in a collective
                failed = True
                raise RuntimeError(f"spawned rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5 if failed else 30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
