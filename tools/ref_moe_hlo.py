"""Collective operand bytes of the JAX reference's compiled train step on a
(2, 2) ("data", "model") mesh of 4 forced host devices, for a dense and an
MoE configuration: what XLA compiles for expert parallelism when the
tokens are not split over "model" (no sequence parallelism).

    PYTHONPATH=src python tools/ref_moe_hlo.py

Reduced configs cut to one layer, 4 x 32 tokens, float32, remat "none";
the reference's own ``make_train_step(..., donate=False)`` lowered and
compiled on placed weights, its optimized HLO read by
``repro.launch.dryrun.collective_bytes``.  Prints one row per
configuration (CPU only, ~30 s).
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.core.compat import make_mesh  # noqa: E402
from repro.launch.dryrun import collective_bytes  # noqa: E402
from repro.models.model_zoo import build  # noqa: E402
from repro.optim.adamw import AdamWConfig  # noqa: E402
from repro.sharding import ctx, rules  # noqa: E402
from repro.train.train_step import init_opt_state, make_train_step  # noqa

B, S = 4, 32
CASES = (("tinyllama-1.1b", {}, "dense"),
         ("granite-moe-3b-a800m", {}, "E=4, top-2: experts over model"),
         ("granite-moe-3b-a800m", {"n_experts": 3},
          "E=3: experts replicated, groups = 1"))


def step_hlo(arch: str, kw: dict, mesh) -> str:
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=1,
                              dtype="float32", remat="none", **kw)
    bundle = build(cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32),
             "labels": jnp.asarray(np.roll(tokens, -1, 1), jnp.int32)}
    with ctx.use(mesh, ("data",)):
        params = bundle.init(jax.random.PRNGKey(0))
        params = jax.device_put(params, rules.param_shardings(params, mesh))
        opt = init_opt_state(params)
        opt = jax.device_put(opt, rules.param_shardings(opt, mesh))
        step = make_train_step(bundle, AdamWConfig(), mesh, donate=False)
        return step.lower(params, opt, batch).compile().as_text()


def main():
    mesh = make_mesh((2, 2), ("data", "model"))
    kinds = ("all-reduce", "all-gather", "all-to-all", "collective-permute")
    print("config | " + " | ".join(kinds))
    for arch, kw, what in CASES:
        got = collective_bytes(step_hlo(arch, kw, mesh))
        print(f"{arch} ({what}) | "
              + " | ".join(f"{got.get(k, 0):,}" for k in kinds), flush=True)


if __name__ == "__main__":
    main()
