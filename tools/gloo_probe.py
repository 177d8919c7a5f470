"""Which gloo collectives take CUDA tensors on this machine, and how fast.

    python3 tools/gloo_probe.py

Spawns 4 processes on the first card (``repro_torch.sharding.procs.
run_ranks``, gloo, a ``file://`` rendezvous under ``build/``), tries each
collective the port's grids use on float32 and bfloat16 CUDA tensors,
then times an all-reduce and an all-gather of 16 and 256 MiB of bfloat16
(the mean of 3 calls, host clock, the card synchronized) and an
all-reduce of the same bytes in host memory.  Prints Python's, torch's
and CUDA's versions, then rank 0's results as JSON.  Needs a card.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))


def rank_fn(rank):
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    world = dist.get_world_size()
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.ones(1024, dtype=dt, device=dev) * (rank + 1)

        def empty(n, dt=dt):
            return torch.empty(n, dtype=dt, device=dev)
        calls = {
            "all_reduce": lambda: dist.all_reduce(x.clone()),
            "all_reduce_max": lambda: dist.all_reduce(
                x.clone(), op=dist.ReduceOp.MAX),
            "all_gather": lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(world)], x),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                empty(1024 * world), x),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                empty(1024 // world), x),
            "all_to_all_single": lambda: dist.all_to_all_single(
                torch.empty_like(x), x),
        }
        for name, fn in calls.items():
            try:
                fn()
                torch.cuda.synchronize()
                out[f"{name}:{dt}"] = "ok"
            except Exception as exc:    # reported, not raised: a probe
                out[f"{name}:{dt}"] = f"{type(exc).__name__}: {exc}"[:200]
    for mib in (16, 256):
        x = torch.randn(mib * 2**20 // 2, device=dev).to(torch.bfloat16)
        xc = x.cpu()
        timed = {
            "all_reduce": lambda: dist.all_reduce(x),
            "all_gather": lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(world)], x),
            "all_reduce_host": lambda: dist.all_reduce(xc),
        }
        for name, fn in timed.items():
            fn()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            out[f"{name}_{mib}MiB_s"] = (time.perf_counter() - t0) / 3
    return out


if __name__ == "__main__":
    import torch
    from repro_torch.sharding.procs import run_ranks
    if not torch.cuda.is_available():
        sys.exit("gloo_probe: no CUDA device")
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    res = run_ranks(rank_fn, 4, timeout=300,
                    rendezvous_dir=os.path.join(HERE, "build", "probe"))
    print(json.dumps(res[0], indent=1))
