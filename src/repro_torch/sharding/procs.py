"""Run one function on several local processes over ``torch.distributed``.

    results = run_ranks(fn, 4, args=(...,), rendezvous_dir=tmp)

starts ``nprocs`` processes (the ``spawn`` start method), joins them into
one process group through a ``file://`` rendezvous in ``rendezvous_dir``
(no network port to pick), calls ``fn(rank, *args)`` in each, and returns
the values in rank order.  ``fn`` must be importable by module path (a
function at the top level of a module), and its arguments and result
picklable.  A rank that raises fails the whole run with that rank's
traceback; a run that outlasts ``timeout`` (a deadlock, a lost rank) is
killed and raises ``TimeoutError``.  Every process it starts is stopped
before it returns.

The backend is the caller's: ``"gloo"`` carries CPU tensors, and CUDA
tensors through host buffers, so several ranks can share one card;
``"nccl"`` needs a card per rank.
"""
from __future__ import annotations

import os
import queue
import time
import traceback


def _rank_main(fn, rank: int, nprocs: int, backend: str, init_method: str,
               args: tuple, threads: int | None, out) -> None:
    import torch
    import torch.distributed as dist
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=nprocs, rank=rank)
        try:
            out.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:   # reported to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, nprocs: int, *, args: tuple = (), rendezvous_dir: str,
              backend: str = "gloo", timeout: float = 300.0,
              threads: int | None = 1, nice: int = 0) -> list:
    """``[fn(0, *args), …, fn(nprocs - 1, *args)]``, each in its own
    process of one ``nprocs``-rank process group (see the module
    docstring).  ``threads`` sets each rank's torch CPU threads (None
    keeps torch's default).  ``nice`` > 0 lowers each rank's CPU
    priority from the moment it starts, its imports included, so that
    ranks sharing a host with other work hold that work back less."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    os.makedirs(rendezvous_dir, exist_ok=True)
    path = os.path.join(rendezvous_dir, f"rendezvous-{os.getpid()}-"
                        f"{time.monotonic_ns()}")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, backend, f"file://{path}",
                               tuple(args), threads, out))
             for r in range(nprocs)]
    deadline = time.monotonic() + timeout
    results: dict[int, object] = {}
    failed: dict[int, str] = {}
    try:
        for p in procs:
            p.start()
            if nice > 0:
                os.setpriority(os.PRIO_PROCESS, p.pid, nice)
        # drain the queue before joining: a child that put a large result
        # does not exit until the parent has read it
        while len(results) + len(failed) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{nprocs} ranks: no result from ranks "
                    f"{sorted(set(range(nprocs)) - set(results) - set(failed))}"
                    f" after {timeout:.0f} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and p.exitcode
                        and r not in results and r not in failed]
                if dead:
                    raise RuntimeError(
                        f"ranks {dead} exited with codes "
                        f"{[procs[r].exitcode for r in dead]} and no result")
                continue
            (results if ok else failed)[rank] = value
            if failed:
                r = min(failed)
                raise RuntimeError(f"rank {r} of {nprocs} failed:\n"
                                   f"{failed[r]}")
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [results[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.pid is None:
                continue                  # never started
            if p.is_alive():
                p.kill()
            p.join(5.0)
        out.close()
        if os.path.exists(path):
            os.remove(path)
