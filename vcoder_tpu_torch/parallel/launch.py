"""Process groups for the port's multi-device mesh (port-only).

The JAX package drives every device from one controller. The port is SPMD:
one process per device, every process running the same driver or engine
code, joined by ``torch.distributed`` (NCCL between CUDA devices, gloo on
the CPU). Two ways in:

* ``python -m torch.distributed.run --nproc-per-node N <module> ...``
  (torchrun) sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the store's
  address; the entry point calls :func:`init_distributed`.
* :func:`spawn` starts ``world`` processes from Python (tests, the smoke
  script): they meet in a ``FileStore`` in a temporary directory (no port
  to pick, so concurrent test workers never collide), run ``fn(rank, world,
  *args)`` and send its result back. The parent joins them with a deadline
  and kills every rank when one fails or the deadline passes, so a hung
  collective fails one call instead of hanging the caller. No rank carries
  on when another has failed.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def in_torchrun() -> bool:
    """True when torchrun (or an equivalent launcher) set this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(device="cuda", *, timeout_s: float = 600.0) -> torch.device:
    """Join the process group described by ``RANK``/``WORLD_SIZE``/
    ``LOCAL_RANK`` (torchrun's environment) and return this rank's device:
    ``cuda:LOCAL_RANK`` (made current) over NCCL, or the CPU over gloo. A
    second call in a process that has joined already only returns the
    device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from vcoder_tpu_torch.device import resolve_device

        resolve_device("cuda")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if not in_torchrun():
            raise RuntimeError("no RANK/WORLD_SIZE in the environment: launch with "
                               "python -m torch.distributed.run, or parallel.launch.spawn")
        dist.init_process_group(backend_for(dev), timeout=datetime.timedelta(seconds=timeout_s),
                                device_id=dev if dev.type == "cuda" else None)
    return dev


def _rank_main(fn, rank, world, store_dir, device, args):
    import faulthandler

    faulthandler.enable()  # a crashing rank leaves its stack on stderr
    out = os.path.join(store_dir, f"result-{rank}.pkl")
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
            torch.cuda.set_device(dev)
        store = dist.FileStore(os.path.join(store_dir, "store"), world)
        backend = backend_for(dev)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300),
                                device_id=dev if backend == "nccl" else None)
        result = fn(rank, world, *args)
        dist.barrier()
        payload = ("ok", result)
    except BaseException:  # reported by the parent
        payload = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:
        pickle.dump(payload, f)
    os.replace(out + ".tmp", out)
    if payload[0] == "ok":
        dist.destroy_process_group()
    os._exit(0 if payload[0] == "ok" else 1)


def spawn(fn: Callable, world: int, *args, timeout_s: float = 120.0, device="cpu",
          tmp_root: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes joined in
    one process group (gloo for ``device="cpu"``, NCCL for CUDA with rank r
    on ``cuda:(r mod the device count)``) and return the
    per-rank results in rank order. ``fn`` and ``args`` must pickle (a
    module-level function); the results too.

    Raises ``RuntimeError`` with the first failing rank's traceback when a
    rank fails, and ``TimeoutError`` when ``timeout_s`` passes first; either
    way every rank still running is killed."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="vcoder-spawn-", dir=tmp_root)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store_dir, device, args), daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        results: List[Any] = [None] * world
        done = [False] * world
        while not all(done):
            # (when written, rank, message): a rank that fails makes its
            # peers fail too, so of the failures seen the earliest written
            # is reported; an exit without a result counts as written now.
            failed = []
            for r, p in enumerate(procs):
                if done[r]:
                    continue
                path = os.path.join(store_dir, f"result-{r}.pkl")
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        status, value = pickle.load(f)
                    if status != "ok":
                        failed.append((os.stat(path).st_mtime_ns, r,
                                       f"rank {r} of {world} failed:\n{value}"))
                    else:
                        results[r], done[r] = value, True
                elif p.exitcode is not None:
                    failed.append((time.time_ns(), r, f"rank {r} of {world} exited with code "
                                                      f"{p.exitcode} without a result"))
            if failed:
                raise RuntimeError(min(failed)[2])
            if time.monotonic() > deadline:
                late = [r for r in range(world) if not done[r]]
                raise TimeoutError(f"ranks {late} of {world} still running after {timeout_s} s")
            time.sleep(0.02)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=5)
        shutil.rmtree(store_dir, ignore_errors=True)
