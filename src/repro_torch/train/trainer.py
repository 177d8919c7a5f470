"""Fault-tolerant training loop (the reference's ``train/trainer.py``).

Behaviours:
  * auto-resume from the latest committed checkpoint,
  * periodic async checkpoints + a final blocking one,
  * SIGTERM/SIGINT → immediate checkpoint then clean exit (preemption),
  * per-step wall-time EMA straggler monitor (flags steps > k·σ),
  * deterministic data: batch = f(seed, step, shard) — restart-safe.

The checkpoint holds ``{"params", "opt"}`` as the reference's trees
(names, stacked layer leaves; ``model_zoo.tree_of``), so a checkpoint
carries across by name.  On a grid of several processes each rank draws
its own rows (``Pipeline(cfg, shard, n_shards)``, its coordinate over the
batch axes; ranks along "model" draw the same rows) and the first rank of
the grid writes the checkpoints.  When the grid's specs split a leaf the
weights are placed (``rules.place_params``): every rank draws them whole
from the same generator and keeps its blocks, so a placed run starts from
one process's weights; a checkpoint gathers the blocks to the writer, so
its files hold whole tensors; a restore reads each rank's blocks
(``CheckpointManager.restore(grid=...)``).  Otherwise (no leaf split)
every rank holds the whole weights and restores the whole checkpoint.
"""
from __future__ import annotations

import dataclasses
import signal
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models.model_zoo import load_tree, opt_state_from_numpy, \
    tree_of
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import rules
from .train_step import init_opt_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_keep: int = 3
    log_every: int = 10
    microbatches: int = 1
    compress_grads: bool = False
    straggler_sigma: float = 3.0
    seed: int = 0


class StragglerMonitor:
    """EMA of step time; flags outliers (straggler mitigation hook)."""

    def __init__(self, sigma: float = 3.0, decay: float = 0.9):
        self.sigma, self.decay = sigma, decay
        self.mean = None
        self.var = 0.0
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        if self.mean is None:
            self.mean = dt
            return False
        slow = bool(dt > self.mean + self.sigma
                    * max(np.sqrt(self.var), 1e-4))
        if slow:
            self.flagged.append((step, dt))
        d = dt - self.mean
        self.mean += (1 - self.decay) * d
        self.var = self.decay * (self.var + (1 - self.decay) * d * d)
        return slow


def data_shard(grid, global_batch: int) -> tuple[int, int]:
    """(this rank's shard, shards): its coordinate over the grid's batch
    axes, major→minor, when they divide the batch; else (0, 1)."""
    axes = rules.batch_axis(grid, global_batch) if grid is not None \
        else None
    shard, n = 0, 1
    for a in axes or ():
        i = grid.axis_index(a)
        shard = shard * grid.shape[i] + grid.coordinate[i]
        n *= grid.shape[i]
    return shard, n


class Trainer:
    def __init__(self, bundle, opt_cfg: AdamWConfig, tcfg: TrainerConfig,
                 data_cfg: DataConfig, grid=None, extra_batch=None):
        self.bundle, self.tcfg = bundle, tcfg
        self.grid = grid
        shard, n = data_shard(grid, data_cfg.global_batch)
        self.pipeline = Pipeline(data_cfg, shard, n)
        rows = slice(shard * self.pipeline.local_batch,
                     (shard + 1) * self.pipeline.local_batch)
        # the stub frontends' inputs: this rank's rows of the global batch
        self.extra_batch = {k: v[rows] for k, v in
                            (extra_batch or {}).items()}
        self.step_fn = make_train_step(
            bundle, opt_cfg, grid, microbatches=tcfg.microbatches,
            compress=tcfg.compress_grads)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.writer = grid is None or not grid.multi_process or \
            grid.ranks.index(_rank()) == 0
        self.monitor = StragglerMonitor(tcfg.straggler_sigma)
        #: whether the weights are placed on the grid (set by run())
        self.placed = False
        self._stop = False
        self.history: list[dict] = []

    # ------------------------------------------------------------ state
    def _place(self, params) -> bool:
        """Place ``params`` on a grid of several processes whose specs
        split a leaf (``self.placed``); False when they stay whole."""
        if self.grid is not None and self.grid.multi_process:
            self.placed = rules.place_params(params, self.grid) is not None
        return self.placed

    def _spec_tree(self, params, opt_keys) -> dict:
        """The checkpoint's spec tree: each leaf's reference spec on the
        grid, the moments' as their parameters'."""
        pspecs = rules.param_specs(params, self.grid)
        ptree = tree_of(params, pspecs, lambda xs: xs[0])
        return {"params": ptree,
                "opt": {k: () if k == "step" else ptree for k in opt_keys}}

    def _save(self, step, params, opt_state, block=False):
        named = dict(params.named_parameters())
        if rules.placement_of(params) is not None:
            # every rank takes part in the gathers; the writer keeps the
            # whole tensors, on the host
            keep = {"keep": self.writer, "device": "cpu"}
            named = rules.gather_named(params, named, **keep)
            opt_state = {k: rules.gather_named(params, v, **keep)
                         if isinstance(v, dict) else v
                         for k, v in opt_state.items()}
        if not self.writer:
            return

        def tree(values):
            return tree_of(params, values)
        opt = {k: tree(v) if isinstance(v, dict) else v
               for k, v in opt_state.items()}
        self.ckpt.save(step, {"params": tree(named), "opt": opt},
                       self._spec_tree(params, opt_state), block=block)

    def _restore_or_init(self, gen):
        latest = self.ckpt.latest_step()
        if latest is not None:
            params = self.bundle.init(None)
            if self._place(params):          # this rank's blocks
                keys = ["m", "v", "step"] + (
                    ["residuals"] if self.tcfg.compress_grads else [])
                step, tree = self.ckpt.restore(
                    grid=self.grid, specs_tree=self._spec_tree(params, keys))
            else:
                step, tree = self.ckpt.restore()
            load_tree(params, tree["params"])
            return step, params, opt_state_from_numpy(params, tree["opt"])
        params = self.bundle.init(gen)
        self._place(params)
        opt = init_opt_state(params, compress=self.tcfg.compress_grads)
        return 0, params, opt

    # ------------------------------------------------------------- run
    def run(self, gen=None):
        """Train to ``total_steps`` from the latest checkpoint, or from
        parameters drawn from ``gen`` (default: a generator on the
        bundle's device seeded with ``tcfg.seed``)."""
        if gen is None:
            gen = torch.Generator(device=self.bundle.device).manual_seed(
                self.tcfg.seed)
        start, params, opt_state = self._restore_or_init(gen)
        dev = self.bundle.device

        def handle(sig, frame):
            self._stop = True
        old = [signal.signal(s, handle)
               for s in (signal.SIGTERM, signal.SIGINT)]
        try:
            step = start
            for step in range(start, self.tcfg.total_steps):
                t0 = time.perf_counter()
                host = self.pipeline.batch_at(step)
                batch = {**{k: torch.from_numpy(v).to(dev)
                            for k, v in host.items()}, **self.extra_batch}
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                slow = self.monitor.observe(step, dt)
                rec = {"step": step, "loss": loss, "dt": dt,
                       "straggler": slow,
                       "grad_norm": float(metrics["grad_norm"])}
                self.history.append(rec)
                if step % self.tcfg.log_every == 0:
                    print(f"step {step:6d} loss {loss:.4f} "
                          f"gnorm {rec['grad_norm']:.3f} {dt*1e3:.0f}ms"
                          + (" [straggler]" if slow else ""), flush=True)
                if step and step % self.tcfg.ckpt_every == 0:
                    self._save(step, params, opt_state)
                if self._stop:
                    print(f"preemption signal at step {step}; "
                          "checkpointing and exiting", flush=True)
                    break
            self._save(step + 1, params, opt_state, block=True)
        finally:
            for s, h in zip((signal.SIGTERM, signal.SIGINT), old):
                signal.signal(s, h)
        return params, opt_state


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()
