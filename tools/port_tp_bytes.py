"""Collective operand bytes of the port's placed train step on a 2×2
("data", "model") grid of 4 CPU processes (gloo), at the configurations
and batch of ``tools/ref_tp_hlo.py``: the port's side of that table.

    PYTHONPATH=src python tools/port_tp_bytes.py [--uneven]

Reduced configs, float32, remat "none", 4 x 32 tokens (Whisper's stub
frames 4 x 16 x d_model): TinyLlama and Mamba-2 cut to one layer,
RecurrentGemma to one (rec, rec, attn) period, Whisper to 2 encoder
layers and 1 decoder layer; with ``--uneven`` the cases of
``tools/ref_tp_hlo.py --uneven`` (heads that the 2-way "model" axis
does not split evenly).  Each rank places the weights
(``sharding/rules.py::place_params``), runs one step on its rows and
reads ``core/grid.py::COLLECTIVE_BYTES``; rank 0's counts are printed
beside ``chip_smoke.py::tp_counted_bytes`` (``ep_counted_bytes`` for the
MoE; the dense decoder's beside nothing).  Imports no JAX (~15 s).
"""
import dataclasses
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

B, S = 4, 32
CASES = (("tinyllama-1.1b", {"n_layers": 1}),
         ("mamba2-370m", {"n_layers": 1}),
         ("recurrentgemma-9b", {"n_layers": 3}),
         ("whisper-small", {"enc_layers": 2, "n_layers": 1}))
UNEVEN = (("whisper-small", {"enc_layers": 2, "n_layers": 1, "n_heads": 3,
                             "n_kv": 3}),
          ("granite-moe-3b-a800m", {"n_layers": 1, "n_heads": 3,
                                    "n_kv": 1}),
          ("recurrentgemma-9b", {"n_layers": 3, "n_heads": 3}),
          ("mamba2-370m", {"n_layers": 1, "d_model": 24}))
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")


def _cfg(arch, kw):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               remat="none", **kw)


def count(rank, cases):
    """Each case's bytes of one placed step on this rank's rows."""
    import numpy as np
    import torch

    from repro_torch.core.grid import ProcGrid, collective_bytes
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx, rules
    from repro_torch.train.train_step import init_opt_state, make_train_step
    grid = ProcGrid.create((2, 2), ("data", "model"), device="cpu")
    rows = slice(grid.coordinate[0] * B // 2, (grid.coordinate[0] + 1) * B
                 // 2)
    out = {}
    for arch, kw in cases:
        cfg = _cfg(arch, kw)
        bundle = build(cfg, device="cpu")
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab, (B, S))
        batch = {"tokens": torch.from_numpy(tokens),
                 "labels": torch.from_numpy(np.roll(tokens, -1, 1))}
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
        with ctx.use(grid, ("data",)):
            model = bundle.init(torch.Generator().manual_seed(0))
            rules.place_params(model, grid)
            step = make_train_step(bundle, AdamWConfig(), grid)
            opt = init_opt_state(model)
            collective_bytes(reset=True)
            step(model, opt, {k: v[rows] for k, v in batch.items()})
            out[arch] = collective_bytes()
    return out


def main():
    from chip_smoke import ep_counted_bytes, tp_counted_bytes
    from repro_torch.core.grid import ProcGrid
    from repro_torch.launch.dryrun import param_leaves
    from repro_torch.models.model_zoo import build
    from repro_torch.sharding.procs import run_ranks
    cases = UNEVEN if "--uneven" in sys.argv[1:] else CASES
    counted = run_ranks(count, 4, args=(cases,),
                        rendezvous_dir=tempfile.mkdtemp())[0]
    grid = ProcGrid.create_abstract((2, 2), ("data", "model"))
    print("config | " + " | ".join(KINDS) + " | arithmetic agrees")
    for arch, kw in cases:
        cfg = _cfg(arch, kw)
        got = counted[arch]
        agrees = "-"
        leaves = param_leaves(build(cfg, device="meta").init(None), grid)
        if cfg.family in ("ssm", "hybrid", "encdec"):
            agrees = str(got == tp_counted_bytes(
                cfg, leaves, grid, tokens=B // 2 * S,
                enc_tokens=B // 2 * cfg.enc_seq, microbatches=1))
        elif cfg.family == "moe":
            agrees = str(got == ep_counted_bytes(
                cfg, leaves, grid, tokens=B // 2 * S, microbatches=1))
        print(f"{arch} | " + " | ".join(f"{got.get(k, 0):,}" for k in KINDS)
              + f" | {agrees}", flush=True)


if __name__ == "__main__":
    main()
