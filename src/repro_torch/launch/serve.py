"""Serving launcher: batched requests through the continuous-batching
engine on a reduced config, with random weights from a seeded generator
(the reference's ``launch/serve.py``; ``--device`` is the port's: the
card unless the caller asks for the CPU).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --requests 6 --max-new 8 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.grid import resolve_device
from repro_torch.models.model_zoo import build
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    bundle = build(cfg, device=dev)
    with torch.inference_mode():
        params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(bundle, slots=args.slots, capacity=args.capacity)
    eng.load(params)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, size=8,
                                        dtype=np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    for r in reqs:
        print(f"req {r.rid}: prompt {r.prompt.tolist()} -> {r.out}")
    print(f"served {len(reqs)} requests in {eng.steps} decode steps "
          f"({args.slots} slots, continuous batching) on {dev}")
    return reqs


if __name__ == "__main__":
    main()
