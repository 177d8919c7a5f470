"""Training launcher (the reference's ``launch/train.py``; ``--device`` is
the port's: the card unless the caller asks for the CPU).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --preset cpu-ci --steps 50 --device cpu

Presets size the run: ``cpu-ci`` trains the reduced config, ``100m`` a
~100M-parameter member of the family, both on one process unless
``--grid`` names a grid of several (``--grid 2x2``: ("data", "model");
three sizes: ("pod", "data", "model")), whose ``torch.distributed``
world the caller has initialized with one process per point; ``full``
trains the published config on the production grid, which needs 256
ranks (512 with ``--multi-pod``) and raises otherwise.  On a grid of
several processes whose specs split a leaf the ``Trainer`` places the
weights of every family (FSDP over the batch axes; over "model" the
heads and MLP columns of the dense, VLM and encoder-decoder models, the
MoE's experts, Mamba-2's SSD heads and the RG-LRU's channels:
``--arch granite-moe-3b-a800m --grid 2x2``, ``--arch mamba2-370m --grid
2x2``), whether "model" splits the heads evenly or not (``--arch
whisper-small --grid 1x8``: 4 reduced heads on 8 model ranks; ``--preset
100m --grid 1x8``: 12 heads on 8; ``--arch granite-moe-3b-a800m --grid
1x16``: the production grid's 16-way "model" axis, which divides none of
Granite-MoE's heads, KV heads and experts, so every model rank holds all
the experts and routes in one global group; ``--preset full``:
Whisper-small's 12 heads and Granite-MoE's 24 on the production grid's
16).
Checkpointing, auto-resume (run again with the same ``--ckpt-dir``:
training continues from the newest committed step) and gradient
compression are flags.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.grid import resolve_device
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_host_grid, make_production_grid
from repro_torch.models.model_zoo import build
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import ctx, rules
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--preset", default="cpu-ci",
                    choices=["cpu-ci", "100m", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fixed-batch", action="store_true",
                    help="repeat step-0 batch (memorization curve for CI)")
    ap.add_argument("--grid", default=None,
                    help="DATAxMODEL or PODxDATAxMODEL: a grid of that many "
                    "processes (torch.distributed initialized by the "
                    "caller); default one process")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    shape = tuple(int(n) for n in args.grid.split("x")) if args.grid \
        else (1, 1)
    axes = ("data", "model") if len(shape) == 2 else \
        ("pod", "data", "model")
    if args.preset == "cpu-ci":
        cfg = cfg.reduced()
        grid = make_host_grid(shape, axes, device=dev)
    elif args.preset == "100m":
        # ~100M-param member of the same family
        cfg = dataclasses.replace(
            cfg.reduced(), name=cfg.name + "-100m", n_layers=12,
            d_model=768, n_heads=12, n_kv=max(cfg.n_kv and 4, 0),
            head_dim=64, d_ff=3072, vocab=32000)
        grid = make_host_grid(shape, axes, device=dev)
    else:
        grid = make_production_grid(multi_pod=args.multi_pod, device=dev)

    bundle = build(cfg, device=dev)
    extra = {}
    if cfg.family == "vlm":
        extra["image_embeds"] = torch.zeros(
            (args.global_batch, cfg.n_img_tokens, cfg.d_model),
            dtype=torch.float32, device=dev)
    if cfg.family == "encdec":
        extra["frames"] = torch.zeros(
            (args.global_batch, cfg.enc_seq, cfg.d_model),
            dtype=torch.float32, device=dev)

    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, microbatches=args.microbatches,
        compress_grads=args.compress_grads)
    dcfg = DataConfig(vocab=cfg.vocab, seq=args.seq,
                      global_batch=args.global_batch)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 1))
    with ctx.use(grid, rules.batch_axis(grid, args.global_batch)):
        trainer = Trainer(bundle, opt, tcfg, dcfg, grid=grid,
                          extra_batch=extra)
        if args.fixed_batch:
            trainer.pipeline.batch_at = \
                lambda step, _f=type(trainer.pipeline).batch_at, \
                p=trainer.pipeline: _f(p, 0)
        trainer.run()
    losses = [h["loss"] for h in trainer.history]
    if losses:
        print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f} "
              f"({len(losses)} steps)")
    return trainer


if __name__ == "__main__":
    main()
