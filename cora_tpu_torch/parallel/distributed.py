"""Multi-process bootstrap: the process group, the global mesh, and a clock
every rank reads alike.

The counterpart of the JAX package's `cora_tpu/parallel/distributed.py`:

  * every process calls :func:`init_distributed` once at startup. The
    group's rendezvous comes from the arguments, from the
    `CORA_COORDINATOR` / `CORA_NUM_PROCESSES` / `CORA_PROCESS_ID`
    variables, or from the environment `torchrun` sets (`RANK`,
    `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`, `LOCAL_RANK`), torch's
    counterpart of a TPU pod's auto-detection. The backend is NCCL for a
    CUDA device and gloo for the CPU; a CUDA process takes the card of its
    local rank;
  * :func:`make_global_mesh` builds the 1-D `graph` mesh over every
    process of the job; `solve_cora(..., mesh=make_global_mesh())` is then
    a multi-process certified solve. The certificate and the polish run on
    every rank from the same replicated state, so no rank leaves the
    others' control flow.

With one process `init_distributed` starts nothing and `make_global_mesh`
makes a group of that one process, so the sharded operator runs unchanged
on one card.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from cora_tpu_torch.parallel.sharding import AXIS, make_mesh, mesh_device


def _device_type(device) -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> bool:
    """Start the process group of a multi-process job.

    Returns True when a group of several processes was started (or exists
    already), False for a single process, which starts nothing. Safe to
    call more than once. Environment overrides, used when arguments are
    omitted:

      CORA_COORDINATOR    host:port of process 0, or an init URL
                          (`tcp://…`, `file://…`)
      CORA_NUM_PROCESSES  total process count
      CORA_PROCESS_ID     this process's rank

    and then `torchrun`'s `WORLD_SIZE` / `RANK`. `device` ("cuda" or "cpu";
    the card when there is one) picks the backend: NCCL or gloo."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coordinator_address = coordinator_address or env.get("CORA_COORDINATOR")
    if num_processes is None:
        num_processes = env.get("CORA_NUM_PROCESSES", env.get("WORLD_SIZE"))
    if process_id is None:
        process_id = env.get("CORA_PROCESS_ID", env.get("RANK"))
    torchrun = "MASTER_ADDR" in env and "WORLD_SIZE" in env
    if coordinator_address is None and not torchrun:
        return False
    if num_processes is None or int(num_processes) <= 1:
        return False  # single-process job: nothing to start
    if process_id is None:
        raise ValueError("a multi-process job needs this process's rank "
                         "(process_id, CORA_PROCESS_ID or RANK)")
    world, rank = int(num_processes), int(process_id)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kind = _device_type(device)
    if kind == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK",
                                          rank % torch.cuda.device_count())))
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=init_method, world_size=world,
                            rank=rank)
    return True


def make_global_mesh(device=None, axis: str = AXIS):
    """1-D mesh over every process of the job, in rank order.

    Without a process group (a single process, `init_distributed` having
    started nothing) this first makes a group of this one process, over an
    in-process store (`torch.distributed.HashStore`, no port or file) with
    the backend of `device` (NCCL on the current card, or gloo), so the
    sharded operator runs on one card (world size 1)."""
    kind = _device_type(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh(kind, axis)


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def mesh_clock(mesh):
    """`elapsed(t0)`: seconds since t0, the largest any rank of `mesh`
    reads (one all_reduce MAX, exact in any order). A wall-clock cap that
    reads it stops every rank at the same iteration; one that reads its own
    clock could stop a rank alone and leave the others waiting in a
    collective."""
    group, device = mesh.get_group(), mesh_device(mesh)

    def elapsed(t0: float) -> float:
        t = torch.tensor([time.time() - t0], dtype=torch.float64,
                         device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return float(t)

    return elapsed
