"""Collective operand bytes of the JAX reference's compiled train step on a
(2, 2) ("data", "model") mesh of 4 forced host devices, for the SSM,
RG-LRU and encoder-decoder families beside the dense decoder: what XLA
compiles for their tensor parallelism over "model".

    PYTHONPATH=src python tools/ref_tp_hlo.py [--uneven]

Reduced configs, float32, remat "none", 4 x 32 tokens (Whisper's stub
frames 4 x 16 x d_model from numpy): TinyLlama and Mamba-2 cut to one
layer, RecurrentGemma to one (rec, rec, attn) period, Whisper to 2
encoder layers and 1 decoder layer.  With ``--uneven`` the same cuts
with heads that the 2-way "model" axis does not split evenly
(``UNEVEN``): Whisper with 3 heads and 3 KV heads, Granite-MoE with 3
heads and 1 KV head, RecurrentGemma with 3 heads, Mamba-2 at d_model 24
(3 SSD heads).  The reference's own
``make_train_step(..., donate=False)`` lowered and compiled on weights
placed by ``param_shardings``, its optimized HLO read by
``repro.launch.dryrun.collective_bytes``.  Prints one row per
configuration (CPU only, ~40 s).
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
CASES = (("tinyllama-1.1b", {"n_layers": 1}, "dense, for scale"),
         ("mamba2-370m", {"n_layers": 1}, "SSD heads over model"),
         ("recurrentgemma-9b", {"n_layers": 3},
          "one (rec, rec, attn) period"),
         ("whisper-small", {"enc_layers": 2, "n_layers": 1},
          "2 encoder, 1 decoder layer"))
UNEVEN = (("whisper-small", {"enc_layers": 2, "n_layers": 1, "n_heads": 3,
                             "n_kv": 3}, "3 heads, 3 KV heads"),
          ("granite-moe-3b-a800m", {"n_layers": 1, "n_heads": 3,
                                    "n_kv": 1}, "3 heads, 1 KV head"),
          ("recurrentgemma-9b", {"n_layers": 3, "n_heads": 3},
           "one period, 3 heads"),
          ("mamba2-370m", {"n_layers": 1, "d_model": 24},
           "3 SSD heads"))


def step_hlo(arch: str, kw: dict, mesh) -> str:
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              remat="none", **kw)
    bundle = build(cfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32),
             "labels": jnp.asarray(np.roll(tokens, -1, 1), jnp.int32)}
    if cfg.family == "encdec":
        batch["frames"] = jnp.asarray(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)), jnp.float32)
    with ctx.use(mesh, ("data",)):
        params = bundle.init(jax.random.PRNGKey(0))
        params = jax.device_put(params, rules.param_shardings(params, mesh))
        opt = init_opt_state(params)
        opt = jax.device_put(opt, rules.param_shardings(opt, mesh))
        step = make_train_step(bundle, AdamWConfig(), mesh, donate=False)
        return step.lower(params, opt, batch).compile().as_text()


def main():
    import sys
    cases = UNEVEN if "--uneven" in sys.argv[1:] else CASES
    mesh = make_mesh((2, 2), ("data", "model"))
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
    print("config | " + " | ".join(kinds))
    for arch, kw, what in cases:
        got = collective_bytes(step_hlo(arch, kw, mesh))
        print(f"{arch} ({what}) | "
              + " | ".join(f"{got.get(k, 0):,}" for k in kinds), flush=True)


if __name__ == "__main__":
    main()
