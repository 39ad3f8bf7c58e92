"""Run a function in N local ranks, one process each.

The JAX package needs no launcher: one controller drives every device. In
the port each card has a process of its own (``dist.sharding``), as
torchrun starts them; ``launch`` is the one-host counterpart that the
CLI's ``--devices N`` uses. Rank i runs ``fn(rank, world, *args)`` in a
spawned process once the default process group is up, and tears the
group down after it:

- ``device="cuda"``: rank i on card i, over NCCL;
- ``device="cuda:k"``: every rank on card k, over gloo (NCCL refuses two
  ranks on one card; gloo stages CUDA tensors through the host);
- ``device="cpu"``: every rank on the CPU, over gloo, with one intra-op
  thread each (the ranks share the host's cores).

Each rank finds RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT as torchrun
sets them, and LOCAL_RANK set to the index of its card (its rank on the
CPU). The card is made current before ``fn`` runs.
"""

from __future__ import annotations

import os
import pickle
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that is free now (for a group's store)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, port, device, args, results):
    device = torch.device(device)
    card = None
    backend = "gloo"
    if device.type == "cuda":
        card = rank if device.index is None else device.index
        backend = "nccl" if device.index is None else "gloo"
        torch.cuda.set_device(card)
    else:
        torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port), LOCAL_RANK=str(rank if card is None else card))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, device_id=torch.device("cuda", card)
                            if backend == "nccl" else None)
    try:
        results.put((rank, fn(rank, world, *args)))
    finally:
        dist.destroy_process_group()


def _tracebacks(context) -> list:
    """The traceback of each rank that raised, which torch's spawn wrapper
    pickled into the rank's error file."""
    traces = []
    for rank, path in enumerate(context.error_files):
        if os.access(path, os.R_OK):
            with open(path, "rb") as fh:
                traces.append(f"-- rank {rank} raised:\n{pickle.load(fh)}")
            os.unlink(path)
    return traces


def launch(fn, world: int, *args, device="cuda", timeout: float | None = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned ranks on
    ``device`` (see the module docstring) and return the ranks' return
    values in rank order. ``fn`` must be importable by name (a module's
    top-level function) and return what pickles (numpy arrays, not
    tensors). An exception in any rank stops every rank and raises
    RuntimeError here with the traceback of each rank that failed (the
    others fail in their next collective); past ``timeout`` seconds the
    ranks are stopped and TimeoutError raised."""
    results = mp.get_context("spawn").SimpleQueue()
    context = mp.start_processes(
        _rank_main, args=(fn, world, free_port(), str(device), args, results),
        nprocs=world, join=False, start_method="spawn",
    )
    got = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            # drain before each join: a rank blocks in put() while the
            # pipe is full
            while not results.empty():
                rank, value = results.get()
                got[rank] = value
            if context.join(timeout=0.05):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"launch: {world} ranks still running after {timeout} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise RuntimeError("launch: " + ("\n".join(_tracebacks(context)) or str(e))) from e
    finally:
        for p in context.processes:
            if p.is_alive():
                p.terminate()
                p.join()
    while not results.empty():
        rank, value = results.get()
        got[rank] = value
    return [got.get(r) for r in range(world)]
