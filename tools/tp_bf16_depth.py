"""The bf16 error of a placed first train step against one process, by
depth: the port's (4 CPU processes over gloo on a 2×2 ("data", "model")
grid) beside the JAX reference's (its placed step on a 2×2 mesh of 4
forced host devices against its own one-device step), on the same
weights and batches.

    PYTHONPATH=src python tools/tp_bf16_depth.py [--arch mamba2-370m]
        [--depths 2,4,8,16,48] [--seeds 5] [--out FILE]

    PYTHONPATH=src python tools/tp_bf16_depth.py --card [--depths 8]
        [--seeds 3] [--first-seed 0]
        [--out experiments/tp_bf16_depth_card.json]

    python tools/tp_bf16_depth.py --fit FILE[,FILE...] [--depths 4]

The arch's reduced config in bfloat16 with remat "full" (as the card
trains it), cut to each depth; per depth and seed the reference draws
the weights from ``PRNGKey(seed)`` (carried to the port by
``params_from_numpy``) and numpy draws ``B`` × ``S`` tokens from
``default_rng(seed)``; both sides take one step in ``MB`` microbatches.
For each (depth, seed) it prints the relative error of the first step's
loss and grad_norm, placed against one process, on both sides; the
records go to ``--out`` (JSON; default
``experiments/tp_bf16_depth.json``).  The port's ranks import this
module, so JAX is imported only in the reference's subprocess (CPU only;
~2 min at the defaults).

With ``--card`` (the port only, on one CUDA card): the arch's published
widths in bfloat16 with remat "full", cut to each depth, on the weights
drawn from ``torch.Generator("cuda").manual_seed(seed)`` and the batch
``chip_smoke.py``'s tensor-parallel phases train (8 x 1024 tokens of
``Pipeline``'s step 0, 2 microbatches); one process's first steps in
this process, freed before 4 processes share the card over gloo on the
2×2 grid.  The card's name and power limit are printed beside the table.

With ``--fit`` (no card, no torch): the maximum-likelihood error model of
the draws of one or more ``--card`` records, and at each of ``--depths``
the limit ``chip_smoke.py`` sets from it, with its margin: how many σ(L)
it lies at, how far above the largest draw, the chance that a sound step
fails it and the chance that a fault multiplying the error k-fold does.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

B, S, MB = 8, 32, 2
OPT = dict(lr=1e-4, warmup_steps=1, total_steps=10)
GRID = ((2, 2), ("data", "model"))


def reduced_cfg(arch: str, depth: int, package: str = "repro_torch"):
    """``arch``'s reduced config in bfloat16, remat "full", ``depth``
    layers, from the reference's or the port's registry."""
    import importlib
    base = importlib.import_module(f"{package}.configs.base")
    return dataclasses.replace(base.get_config(arch).reduced(),
                               dtype="bfloat16", remat="full",
                               n_layers=depth)


def batch(cfg, seed: int) -> dict:
    import numpy as np
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def _unflatten(flat) -> dict:
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


# ------------------------------------------------------------ the reference
def reference(job: dict) -> None:
    """The reference's weights of each case (saved flat, float32) and its
    first steps, one-device and placed (run in a subprocess whose
    ``XLA_FLAGS`` force 4 host devices)."""
    os.nice(job["nice"])
    import jax
    import numpy as np

    from repro.core.compat import mesh_from_devices
    from repro.models.model_zoo import build
    from repro.optim.adamw import AdamWConfig
    from repro.sharding import ctx, rules
    from repro.train.train_step import init_opt_state, make_train_step
    assert jax.device_count() >= 4
    mesh = mesh_from_devices(np.array(jax.devices()[:4]).reshape(GRID[0]),
                             GRID[1])
    out = {}
    for depth in job["depths"]:
        cfg = reduced_cfg(job["arch"], depth, "repro")
        bundle = build(cfg)
        one = make_train_step(bundle, AdamWConfig(**OPT),
                              microbatches=MB, donate=False)
        with ctx.use(mesh, ("data",)):
            placed = make_train_step(bundle, AdamWConfig(**OPT), mesh,
                                     microbatches=MB, donate=False)
        for seed in job["seeds"]:
            init = bundle.init(jax.random.PRNGKey(seed))
            flat = {"/".join(k.key for k in path):
                    np.asarray(v, dtype=np.float32) for path, v in
                    jax.tree_util.tree_flatten_with_path(init)[0]}
            np.savez(os.path.join(job["dir"], f"w{depth}_{seed}.npz"),
                     **flat)
            b = {k: jax.numpy.asarray(v) for k, v in
                 batch(cfg, seed).items()}
            _, _, met = one(init, init_opt_state(init), b)
            rec = {"loss_one": float(met["loss"]),
                   "grad_norm_one": float(met["grad_norm"])}
            with ctx.use(mesh, ("data",)):
                params = jax.device_put(init,
                                        rules.param_shardings(init, mesh))
                opt = init_opt_state(params)
                opt = jax.device_put(opt, rules.param_shardings(opt, mesh))
                _, _, met = placed(params, opt, b)
            rec.update(loss_placed=float(met["loss"]),
                       grad_norm_placed=float(met["grad_norm"]))
            out[f"{depth}/{seed}"] = rec
            print(f"reference depth {depth} seed {seed}: {rec}",
                  flush=True)
    with open(os.path.join(job["dir"], "reference.json"), "w") as f:
        json.dump(out, f)


# ----------------------------------------------------------------- the port
def port_rank(rank, job):
    """Each case's first step placed on this rank's rows; on rank 0 also
    one process's on the whole batch."""
    import numpy as np
    import torch

    from repro_torch.core.grid import ProcGrid
    from repro_torch.models.model_zoo import build, params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx, rules
    from repro_torch.train.train_step import init_opt_state, make_train_step
    torch.set_num_threads(1)
    grid = ProcGrid.create(*GRID, device="cpu")
    d = grid.coordinate[0]
    rows = slice(d * B // 2, (d + 1) * B // 2)
    out = {}
    for depth in job["depths"]:
        cfg = reduced_cfg(job["arch"], depth)
        bundle = build(cfg, device="cpu")
        for seed in job["seeds"]:
            w = _unflatten(dict(np.load(os.path.join(
                job["dir"], f"w{depth}_{seed}.npz"))))
            b = {k: torch.from_numpy(v) for k, v in
                 batch(cfg, seed).items()}
            rec = {}
            with ctx.use(grid, ("data",)):
                model = params_from_numpy(cfg, w, device="cpu")
                rules.place_params(model, grid)
                step = make_train_step(bundle, AdamWConfig(**OPT), grid,
                                       microbatches=MB)
                _, _, met = step(model, init_opt_state(model),
                                 {k: v[rows] for k, v in b.items()})
            rec.update(loss_placed=float(met["loss"]),
                       grad_norm_placed=float(met["grad_norm"]))
            if rank == 0:
                model = params_from_numpy(cfg, w, device="cpu")
                step = make_train_step(bundle, AdamWConfig(**OPT),
                                       microbatches=MB)
                _, _, met = step(model, init_opt_state(model), b)
                rec.update(loss_one=float(met["loss"]),
                           grad_norm_one=float(met["grad_norm"]))
            out[f"{depth}/{seed}"] = rec
    return out


def errors(rec: dict) -> tuple[float, float]:
    """(loss, grad_norm): placed against one process, signed, relative."""
    return tuple((rec[f"{k}_placed"] - rec[f"{k}_one"]) / abs(rec[f"{k}_one"])
                 for k in ("loss", "grad_norm"))


# ------------------------------------------------------------ the model
#: z of the CPU bound, |error| <= Z·σ(L) of ``CPU_MODEL`` (the tests' and
#: ``--predict``'s; the card's limit is ``chip_smoke.py``'s, one z on the
#: upper bound of the card's σ), by kind: the loss's error is normal
#: (the largest of 100 CPU draws at 3.2σ; a two-sided normal tail of
#: 6.3e-5 beyond 4σ); the grad_norm's has heavier tails (a weight draw
#: whose grad_norm is sensitive moves both packages alike: the largest of
#: 100 draws at 5.3σ), so its limit stands at 1.5 times that
Z = {"loss": 4.0, "grad_norm": 8.0}
#: σ(L) = s·L^α of Mamba-2 370M's reduced config on the CPU (2×2, 8 x 32
#: tokens in 2 microbatches), fitted to both packages' draws together
#: (``--seeds 10``: 10 weight seeds at each of 2, 4, 8, 16, 48 layers,
#: 100 draws a kind): (s, α) by kind
CPU_MODEL = {"loss": (5.708e-6, 1.24), "grad_norm": (2.250e-3, 1.09)}


def fit(draws, alpha: float | None = None) -> tuple[float, float]:
    """(s, α) of the error model σ(L) = s·L^α, by maximum likelihood over
    ``draws`` [(depth L, signed relative error)], each normal with mean 0
    and deviation σ(L); α on a grid of 0.01 unless given."""
    import math
    xs = [(L, x) for L, x in draws]

    def s_of(a):
        return math.sqrt(sum(x * x / L ** (2 * a) for L, x in xs) / len(xs))

    def loglik(a):
        s = s_of(a)
        return -sum(math.log(s * L ** a) for L, _ in xs)
    if alpha is None:
        alpha = max((i / 100 for i in range(0, 301)), key=loglik)
    return s_of(alpha), alpha


def by_kind(records: dict) -> dict:
    """{"loss": [(L, error)], "grad_norm": [...]} of records keyed
    "depth/seed"."""
    out = {"loss": [], "grad_norm": []}
    for key, rec in records.items():
        L = int(key.split("/")[0])
        dl, dg = errors(rec)
        out["loss"].append((L, dl))
        out["grad_norm"].append((L, dg))
    return out


def print_fit(what: str, draws, alpha=None) -> tuple[float, float]:
    s, a = fit(draws, alpha)
    depths = sorted({L for L, _ in draws})
    print(f"  {what}: sigma(L) = {s:.3e} * L^{a:.2f} over {len(draws)} "
          f"draws; per depth RMS / model: " + ", ".join(
              f"{L}: {_rms([x for d, x in draws if d == L]):.2e} / "
              f"{s * L ** a:.2e}" for L in depths))
    return s, a


def _rms(xs) -> float:
    return (sum(x * x for x in xs) / len(xs)) ** 0.5


def measure(arch: str, depths, seeds, workdir: str, nice: int = 0) -> dict:
    """{"reference": {...}, "port": {...}}: per "depth/seed" the losses and
    grad norms of both steps on each side; ``nice`` lowers the CPU
    priority of the reference's subprocess and of the ranks."""
    from repro_torch.sharding.procs import run_ranks
    job = {"arch": arch, "depths": list(depths), "seeds": list(seeds),
           "dir": workdir, "nice": nice}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(HERE, "src"))
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--reference-job", json.dumps(job)], env=env,
                   check=True)
    with open(os.path.join(workdir, "reference.json")) as f:
        ref = json.load(f)
    ranks = run_ranks(port_rank, 4, args=(job,), rendezvous_dir=workdir,
                      timeout=3600, nice=nice)
    port = ranks[0]
    for r in ranks[1:]:
        for key, rec in r.items():
            assert rec["loss_placed"] == port[key]["loss_placed"], key
    return {"reference": ref, "port": port}


# ----------------------------------------------------------------- the card
CARD_SEQ, CARD_BATCH = 1024, 8


def card_cfg(arch: str, depth: int):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch), dtype="bfloat16",
                               remat="full", n_layers=depth)


def card_batch(cfg, shard: int = 0, shards: int = 1) -> dict:
    from repro_torch.data.pipeline import DataConfig, Pipeline
    dcfg = DataConfig(vocab=cfg.vocab, seq=CARD_SEQ,
                      global_batch=CARD_BATCH)
    return Pipeline(dcfg, shard, shards).batch_at(0)


def card_step(cfg, seed: int, dev, grid=None) -> dict:
    """One first step on the card from the weights drawn from ``seed``:
    placed on ``grid`` (this rank's rows) or in one process."""
    import torch

    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import ctx, rules
    from repro_torch.train.train_step import init_opt_state, make_train_step
    bundle = build(cfg, device=dev)
    model = bundle.init(torch.Generator(device=dev).manual_seed(seed))
    if grid is None:
        b = card_batch(cfg)
        step = make_train_step(bundle, AdamWConfig(**OPT), microbatches=MB)
        _, _, met = step(model, init_opt_state(model),
                         {k: torch.from_numpy(v).to(dev)
                          for k, v in b.items()})
    else:
        d = grid.coordinate[0]
        b = card_batch(cfg, d, GRID[0][0])
        with ctx.use(grid, ("data",)):
            rules.place_params(model, grid)
            step = make_train_step(bundle, AdamWConfig(**OPT), grid,
                                   microbatches=MB)
            _, _, met = step(model, init_opt_state(model),
                             {k: torch.from_numpy(v).to(dev)
                              for k, v in b.items()})
    out = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])}
    del model, step
    torch.cuda.empty_cache()
    return out


def card_rank(rank, job):
    import torch

    from repro_torch.core.grid import ProcGrid
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    grid = ProcGrid.create(*GRID, device=dev)
    return {f"{d}/{s}": card_step(card_cfg(job["arch"], d), s, dev, grid)
            for d in job["depths"] for s in job["seeds"]}


def measure_card(arch: str, depths, seeds, workdir: str) -> dict:
    """Per "depth/seed" the placed and one-process first steps' losses and
    grad norms on the card (the port only)."""
    import torch

    from repro_torch.sharding.procs import run_ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    one = {f"{d}/{s}": card_step(card_cfg(arch, d), s, dev)
           for d in depths for s in seeds}
    ranks = run_ranks(card_rank, 4, args=({"arch": arch,
                                           "depths": list(depths),
                                           "seeds": list(seeds)},),
                      rendezvous_dir=workdir, timeout=3000, threads=2,
                      nice=19)
    out = {}
    for key, rec in one.items():
        assert all(r[key]["loss"] == ranks[0][key]["loss"] for r in ranks)
        out[key] = {"loss_one": rec["loss"],
                    "grad_norm_one": rec["grad_norm"],
                    "loss_placed": ranks[0][key]["loss"],
                    "grad_norm_placed": ranks[0][key]["grad_norm"]}
    return out


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main_card(args) -> int:
    depths = [int(x) for x in args.depths.split(",")]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        res = measure_card(args.arch, depths, range(
            args.first_seed, args.first_seed + args.seeds), d)
    gpu = gpu_line()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": gpu, "arch": args.arch, "B": CARD_BATCH,
                   "S": CARD_SEQ, "microbatches": MB, "port": res}, f,
                  indent=1)
    print(f"{args.arch} at published widths, bf16, remat \"full\", "
          f"{CARD_BATCH} x {CARD_SEQ} tokens in {MB} microbatches, 2x2, 4 "
          f"processes on one card over gloo ({gpu}): first step placed vs "
          f"one process, relative (signed); {time.perf_counter() - t0:.1f}"
          " s")
    print("depth seed | loss | grad_norm | one process's loss, grad_norm")
    for key, rec in res.items():
        dl, dg = errors(rec)
        depth, seed = key.split("/")
        print(f"{depth:>5} {seed:>4} | {dl:+.3e} | {dg:+.3e} | "
              f"{rec['loss_one']:.6f}, {rec['grad_norm_one']:.6f}")
    print("error model (maximum likelihood):")
    for kind, draws in by_kind(res).items():
        print_fit(kind, draws)
    return 0


def main_predict(args) -> int:
    """σ(L) and the limit Z·σ(L) at ``--depths`` from earlier draws
    ("L:error,..." per kind) and a given α per kind."""
    depths = [int(x) for x in args.depths.split(",")]
    for kind, spec, a in (("loss", args.predict_loss, args.alpha_loss),
                          ("grad_norm", args.predict_grad_norm,
                           args.alpha_grad_norm)):
        if not spec:
            continue
        draws = [(int(L), float(x)) for L, x in
                 (p.split(":") for p in spec.split(","))]
        s, _ = fit(draws, a)
        print(f"{kind}: from {draws} at alpha {a}: s = {s:.3e}; "
              + ", ".join(f"L = {L}: sigma {s * L ** a:.2e}, Z·sigma "
                          f"{Z[kind] * s * L ** a:.2e}" for L in depths))
    return 0


def main_fit(args) -> int:
    """The card's error model from the draws of the ``--fit`` files
    (``--card`` records; a "depth/seed" key in several is taken once),
    and ``chip_smoke.py``'s limit at ``--depths``: MAMBA_BF16_Z times the
    95% upper bound of σ(L) (``sigma_upper``), the chance that a sound
    step fails it, and the chance that a fault multiplying the error by
    k fails it, each draw normal with deviation σ(L) of the fit."""
    import math
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    port, card = {}, set()
    for path in args.fit.split(","):
        with open(path) as f:
            rec = json.load(f)
        card.add(rec["card"])
        for key, r in rec["port"].items():
            port.setdefault(key, r)
    print(f"{len(port)} draws from {args.fit} ({', '.join(sorted(card))})")
    z = cs.MAMBA_BF16_Z
    for kind, draws in by_kind(port).items():
        s, a = print_fit(kind, draws)
        up = cs.sigma_upper(s, len(draws))
        print(f"  {kind}: the largest |error| / sigma(L) "
              f"{max(abs(x) / (s * L ** a) for L, x in draws):.2f}; the "
              f"95% upper bound of s {up:.3e} ({up / s:.3f} s)")
        for L in (int(x) for x in args.depths.split(",")):
            sig, lim = s * L ** a, z * up * L ** a
            seen = [abs(x) for d, x in draws if d == L]
            print(f"    L = {L}: sigma {sig:.3e}, limit {z:g} x upper "
                  f"bound {lim:.3e} = {lim / sig:.2f} sigma"
                  + (f", {lim / max(seen):.2f} x the largest of its "
                     f"{len(seen)} draws" if seen else "")
                  + f"; a sound step fails it with a chance "
                  f"{math.erfc(lim / sig / math.sqrt(2)):.1e}; a fault "
                  "multiplying the error by k fails it with a chance "
                  + ", ".join(
                      f"{math.erfc(lim / (k * sig) / math.sqrt(2)):.2f} "
                      f"(k = {k})" for k in (2, 3, 5, 10, 20))
                  + f"; even chances at k = {lim / sig / 0.6745:.1f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--depths", default="2,4,8,16,48")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--first-seed", type=int, default=0,
                    help="with --card: seeds first-seed, first-seed + 1, ...")
    ap.add_argument("--out", default=os.path.join(HERE, "experiments",
                                                  "tp_bf16_depth.json"))
    ap.add_argument("--card", action="store_true",
                    help="the port alone, at published widths, on a card")
    ap.add_argument("--predict-loss", help="earlier draws L:error,...")
    ap.add_argument("--predict-grad-norm", help="earlier draws L:error,...")
    ap.add_argument("--alpha-loss", type=float, default=0.5)
    ap.add_argument("--alpha-grad-norm", type=float, default=0.5)
    ap.add_argument("--fit", help="--card records FILE,...: the card's "
                    "model and limits at --depths")
    ap.add_argument("--reference-job", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.fit:
        return main_fit(args)
    if args.predict_loss or args.predict_grad_norm:
        return main_predict(args)
    if args.reference_job:
        reference(json.loads(args.reference_job))
        return 0
    if args.card:
        return main_card(args)
    depths = [int(x) for x in args.depths.split(",")]
    with tempfile.TemporaryDirectory() as d:
        res = measure(args.arch, depths, range(args.seeds), d)
    res.update(arch=args.arch, B=B, S=S, microbatches=MB)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"{args.arch} reduced, bf16, remat \"full\", {B} x {S} tokens in "
          f"{MB} microbatches, 2x2: first step placed vs one process, "
          "relative (signed)")
    print("depth seed | port loss | reference loss | port grad_norm | "
          "reference grad_norm")
    for key in res["port"]:
        pl, pg = errors(res["port"][key])
        rl, rg = errors(res["reference"][key])
        depth, seed = key.split("/")
        print(f"{depth:>5} {seed:>4} | {pl:+.3e} | {rl:+.3e} | {pg:+.3e} | "
              f"{rg:+.3e}")
    print("error model, each side and both together (maximum "
          "likelihood):")
    for kind in ("loss", "grad_norm"):
        both = []
        for side in ("port", "reference"):
            draws = by_kind(res[side])[kind]
            print_fit(f"{side} {kind}", draws)
            both += draws
        s, a = print_fit(f"both {kind}", both)
        worst = {side: max(abs(x) / (s * L ** a)
                           for L, x in by_kind(res[side])[kind])
                 for side in ("port", "reference")}
        print(f"  {kind}: the largest |error| / sigma(L) of each side: "
              + ", ".join(f"{k} {v:.2f}" for k, v in worst.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
