"""Device meshes and the process world under them (counterpart of
``repro/launch/mesh.py``).

The port runs SPMD, one process per rank, on a ``torch.distributed``
process group: NCCL when the ranks' tensors live on CUDA cards, gloo when
they live on the CPU, chosen by the device the caller asks for (the card
by default, as everywhere in the port). A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over that world with the
reference's axis names: ``("data", "model")`` or ``("pod", "data",
"model")``.

``init_world`` starts the process group: from the environment a launcher
such as ``torchrun`` set (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), else
through a ``file://`` rendezvous (a world of one by default).
``spawn_world`` runs a function on a gloo world of processes it starts
itself, the counterpart of the reference's forced host device count, and
joins them with a time limit. Nothing here touches the process group when
the module is imported.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_lib
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# Published figures of one NVIDIA H100 SXM (data sheet, dense rates, at
# its 700 W limit), used by the router dry-run's reckoning.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, outside the tensor cores
HBM_BW = 3.35e12              # bytes/s
ICI_BW = 450e9                # bytes/s, NVLink, each way

# a collective that waits longer than this fails instead of hanging
TIMEOUT = datetime.timedelta(seconds=120)


def backend_for(device) -> str:
    """The process group's back end for tensors on ``device``."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def init_world(device=None, *, init_method: str | None = None,
               rank: int | None = None,
               world_size: int | None = None) -> None:
    """Start this process's rank of the world (no-op when a process group
    exists). Rank and size come from the arguments, else from a launcher's
    environment (``torchrun`` sets ``RANK`` and ``WORLD_SIZE``, and the
    ``env://`` rendezvous reads ``MASTER_ADDR``), else rank 0 of a world of
    one through a ``file://`` rendezvous in a fresh temporary directory.
    On a card the rank takes card ``LOCAL_RANK`` (or its rank modulo the
    card count) and runs one collective, so a CUDA graph captured later
    finds NCCL's communicator made."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    env = os.environ
    if rank is None:
        rank = int(env.get("RANK", 0))
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    if init_method is None:
        if "MASTER_ADDR" in env:
            init_method = "env://"
        else:
            path = os.path.join(tempfile.mkdtemp(prefix="repro_world_"),
                                "rdv")
            init_method = f"file://{path}"
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=TIMEOUT)
    if dev.type == "cuda":
        t = torch.ones((1,), device=torch.device("cuda",
                                                 torch.cuda.current_device()))
        dist.all_reduce(t)
        torch.cuda.synchronize()


def close_world() -> None:
    """Destroy the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _device_type(device) -> str:
    return resolve_device(device).type


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"): a world of 256 or 512 ranks (real, or the ``fake``
    back end of the dry-run)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_debug_mesh(data: int = 1, model: int = 1, device=None):
    """A (data, model) mesh over the current world of data * model ranks
    (tests, ``serve --mesh``)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device), (data, model),
                            mesh_dim_names=("data", "model"))


def n_chips(mesh) -> int:
    return int(mesh.size())


# ---------------------------------------------------------------------------
# A gloo world of spawned processes
# ---------------------------------------------------------------------------

def _rank_main(rank, world_size, init_method, fn, args, out):
    torch.set_num_threads(1)
    try:
        init_world("cpu", init_method=init_method, rank=rank,
                   world_size=world_size)
        got = fn(*args)
        out.put((rank, True, got))
    except BaseException:                       # noqa: BLE001
        out.put((rank, False, traceback.format_exc()))
    finally:
        close_world()


def spawn_world(fn, world_size: int, args: tuple = (), *,
                timeout: float | None = 120.0,
                rdv_dir: str | None = None) -> list:
    """Run ``fn(*args)`` on every rank of a gloo world of ``world_size``
    CPU processes (spawned, one thread each, rendezvous through a file in
    ``rdv_dir`` or a fresh temporary directory) and return the ranks'
    results in rank order. ``fn`` must be importable by a spawned child.
    A rank that raises, or a world that outlives ``timeout`` seconds, has
    every rank terminated and raises ``RuntimeError`` (``timeout`` None:
    no limit)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    rdv_dir = rdv_dir or tempfile.mkdtemp(prefix="repro_world_")
    path = os.path.join(rdv_dir, f"rdv_{os.getpid()}_{time.time_ns()}")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, f"file://{path}", fn, args,
                               out), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, failure = {}, None
    deadline = time.monotonic() + (float("inf") if timeout is None
                                   else timeout)
    try:
        while len(results) < world_size and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = (f"the world of {world_size} did not finish in "
                           f"{timeout} s")
                break
            try:
                rank, ok, got = out.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    failure = f"a rank died with exit code {dead[0]}"
                continue
            if ok:
                results[rank] = got
            else:
                failure = f"rank {rank} raised:\n{got}"
    finally:
        for p in procs:
            p.join(timeout=min(60.0, max(1.0, deadline - time.monotonic()))
                   if failure is None else 1.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        out.close()
    if failure is not None:
        raise RuntimeError(failure)
    return [results[r] for r in range(world_size)]
