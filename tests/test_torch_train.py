"""The port's LM training path against the reference's.

* Loss and gradients: every family (one config of each) at ``reduced()``,
  float32, on the reference's ``PRNGKey(0)`` weights carried across with
  ``params_from_numpy``; the port's ``loss.backward`` at ``remat`` none,
  full and dots against ``jax.value_and_grad`` of the reference's loss
  (jitted, at its config's remat: remat changes no value).  Loss within
  1e-5 relative; every gradient within 1e-5 of the largest gradient
  magnitude (float32 sums in another order; measured ≤ 3e-6).
* Remat is real: under "full" the backward recomputes every layer's
  matrix products (``aten.mm`` and ``aten.bmm`` run again), under "dots"
  only the batched ones (the products with no batch dimension are saved,
  as ``dots_with_no_batch_dims_saveable`` saves them); with gradients off
  it changes nothing.
* ``chunked_xent`` with chunk < S and with a mask, value and gradients
  against the reference's (1e-5 of the largest).
* ``make_train_step`` with microbatches 1 and 2, compression off and on:
  3 steps from carried-across weights and optimizer state against the
  reference's jitted step.  Without compression: loss, grad_norm and lr
  within 1e-5 relative at every step, parameters and moments afterwards
  within 1e-4 of their largest magnitude.  With compression the int8
  codes of a gradient element that sits at a rounding boundary can
  differ between the two packages (their gradients differ by ~1e-6), and
  the code of a flipped element moves by the whole quantisation step;
  Adam's update of such an element is then close to ±lr with either
  sign: the first step is held at 1e-5, later steps' loss at 1e-4 and
  grad_norm at 1e-2 relative (measured 8.6e-6 and 1.5e-3), and every
  parameter within 2·lr per step of the reference's (measured 1.8e-3
  after 3 steps at lr 1e-3), with at most 1% of the elements beyond
  1e-4.
* The reference's model smoke test (one train step of every
  ``ARCH_IDS`` config), its train → checkpoint → serve lifecycle
  (``tests/test_system.py``), ``aux_load_balance_loss``, and the
  launcher (``python -m repro_torch.launch.train --preset cpu-ci
  --device cpu``, the VLM's image embeddings and the encoder-decoder's
  frames included).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as ref_config
from repro.models import model_zoo as ref_zoo
from repro.models import moe as ref_moe
from repro.models.model_zoo import build as ref_build
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.train.train_step import init_opt_state as ref_init_opt
from repro.train.train_step import make_train_step as ref_make_step
from repro_torch.configs.base import get_config
from repro_torch.models import model_zoo, moe
from repro_torch.models.model_zoo import build, opt_state_from_numpy, \
    params_from_numpy, state_to_numpy, tree_of
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import init_opt_state, make_train_step

KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
RTOL = 1e-5
FAMILIES = ("tinyllama-1.1b", "granite-moe-3b-a800m", "pixtral-12b",
            "mamba2-370m", "recurrentgemma-9b", "whisper-small")
REMATS = ("none", "full", "dots")


def _np_batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.family == "vlm":
        b["image_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        b["frames"] = (0.1 * rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model))).astype(np.float32)
    return b


def _ref(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(reference params as numpy, loss, gradient tree) on one batch."""
    rcfg = ref_config(arch).reduced()
    rm = ref_build(rcfg)
    rp = rm.init(KEY)
    nb = _np_batch(rcfg)
    loss, grads = jax.jit(jax.value_and_grad(rm.loss))(rp, _ref(nb))
    return (jax.tree.map(np.asarray, rp), float(loss),
            jax.tree.map(np.asarray, grads), nb)


def _port_grads(arch, remat):
    rp, _, _, nb = _reference(arch)
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
    model = params_from_numpy(cfg, rp, device=CPU)
    bundle = build(cfg, device=CPU)
    batch = _port(nb)
    batch["labels"] = batch["labels"].long()
    batch["tokens"] = batch["tokens"].long()
    loss = bundle.loss(model, batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return float(loss.detach()), state_to_numpy(model, {"g": grads})["g"]


def _tree_err(got, want) -> float:
    scale = max(float(np.abs(x).max()) for x in jax.tree.leaves(want))
    errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max()), got, want)
    return max(jax.tree.leaves(errs)) / scale


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_the_reference(arch, remat):
    _, rloss, rgrads, _ = _reference(arch)
    loss, grads = _port_grads(arch, remat)
    assert abs(loss - rloss) <= RTOL * abs(rloss)
    assert jax.tree.structure(grads) == jax.tree.structure(rgrads)
    assert _tree_err(grads, rgrads) <= RTOL


class _Count(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.ops:
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-3b-a800m"])
def test_remat_recomputes_what_its_policy_does_not_save(arch):
    rp, _, _, nb = _reference(arch)
    counts = {}
    for remat in REMATS:
        cfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
        model = params_from_numpy(cfg, rp, device=CPU)
        batch = {k: v.long() for k, v in _port(nb).items()}
        loss = build(cfg, device=CPU).loss(model, batch)
        with _Count() as c:
            loss.backward()
        counts[remat] = c.ops
    none, full, dots = (counts[r] for r in REMATS)
    # "full" runs every product of the forward again; "dots" only the
    # batched ones (its mm outputs were saved)
    assert full["mm"] > none["mm"] and full["bmm"] > none["bmm"]
    assert dots["mm"] == none["mm"] and dots["bmm"] == full["bmm"]


@pytest.mark.parametrize("remat", REMATS)
def test_remat_does_nothing_without_gradients(remat):
    rp, _, _, nb = _reference("tinyllama-1.1b")
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              remat=remat)
    model = params_from_numpy(cfg, rp, device=CPU)
    bundle = build(cfg, device=CPU)
    batch = {k: v.long() for k, v in _port(nb).items()}
    with torch.inference_mode():
        h = bundle.forward(model, batch)
    base = build(dataclasses.replace(cfg, remat="none"), device=CPU)
    with torch.inference_mode():
        assert torch.equal(h, base.forward(model, batch))


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_xent_matches_the_reference(masked):
    rp, _, _, _ = _reference("tinyllama-1.1b")
    cfg = get_config("tinyllama-1.1b").reduced()
    rcfg = ref_config("tinyllama-1.1b").reduced()
    rng = np.random.default_rng(5)
    B, S, chunk = 2, 24, 8                     # three chunks of 8
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.6).astype(np.float32) if masked \
        else None

    def ref_loss(params, h):
        return ref_zoo.chunked_xent(params, h, jnp.asarray(labels), rcfg,
                                    chunk=chunk, mask=None if mask is None
                                    else jnp.asarray(mask))
    rl, (rgp, rgh) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, rp), jnp.asarray(h))

    model = params_from_numpy(cfg, rp, device=CPU)
    ht = torch.from_numpy(h).requires_grad_(True)
    loss = model_zoo.chunked_xent(
        model, ht, torch.from_numpy(labels).long(), cfg, chunk=chunk,
        mask=None if mask is None else torch.from_numpy(mask))
    loss.backward()
    assert abs(float(loss.detach()) - float(rl)) <= RTOL * abs(float(rl))
    gh = ht.grad.numpy()
    assert np.abs(gh - np.asarray(rgh)).max() <= RTOL * np.abs(
        np.asarray(rgh)).max()
    head = model.lm_head.grad.numpy()
    want = np.asarray(rgp["lm_head"])
    assert np.abs(head - want).max() <= RTOL * np.abs(want).max()


def test_aux_load_balance_loss_matches_the_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    top = np.argsort(-logits, axis=-1)[:, :2]
    got = moe.aux_load_balance_loss(torch.from_numpy(logits),
                                    torch.from_numpy(top), 8)
    want = ref_moe.aux_load_balance_loss(jnp.asarray(logits),
                                         jnp.asarray(top), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------ train step
STEP_CASES = [(1, False), (2, False), (1, True), (2, True)]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("mb,compress", STEP_CASES,
                         ids=[f"mb{m}-{'comp' if c else 'plain'}"
                              for m, c in STEP_CASES])
def test_train_step_matches_the_reference(mb, compress):
    arch = "tinyllama-1.1b"
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    rm = ref_build(rcfg)
    rp = rm.init(KEY)
    ro = ref_init_opt(rp, compress=compress)
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, rp), device=CPU)
    po = opt_state_from_numpy(model, jax.tree.map(np.asarray, ro))
    assert set(po) == set(ro)
    rstep = jax.jit(ref_make_step(rm, RefAdamWConfig(**OPT),
                                  microbatches=mb, compress=compress,
                                  donate=False))
    pstep = make_train_step(build(cfg, device=CPU), AdamWConfig(**OPT),
                            microbatches=mb, compress=compress)
    nb = _np_batch(cfg, B=4, S=16)
    lr = OPT["lr"]
    for s in range(3):
        rp, ro, rmet = rstep(rp, ro, _ref(nb))
        model, po, met = pstep(model, po, _port(nb))
        assert _rel(float(met["lr"]), float(rmet["lr"])) <= 1e-6
        later = compress and s > 0
        assert _rel(float(met["loss"]), float(rmet["loss"])) <= \
            (1e-4 if later else RTOL)
        assert _rel(float(met["grad_norm"]), float(rmet["grad_norm"])) <= \
            (1e-2 if later else RTOL)
        if compress:
            diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
                jax.tree.leaves(state_to_numpy(model)),
                jax.tree.leaves(jax.tree.map(np.asarray, rp)))])
            assert diff.max() <= 2 * lr * (s + 1)
            assert (diff > lr / 2).mean() <= 0.01
            if s == 0:
                assert (diff > 1e-5).mean() <= 0.01
    assert int(po["step"]) == int(ro["step"]) == 3
    if not compress:
        got, want = state_to_numpy(model), jax.tree.map(np.asarray, rp)
        assert _tree_err(got, want) <= 1e-4
        st = state_to_numpy(model, po)
        for key in ("m", "v"):
            assert _tree_err(st[key], jax.tree.map(np.asarray, ro[key])) \
                <= 1e-4


def test_train_step_keeps_the_inputs_without_donation():
    arch = "tinyllama-1.1b"
    cfg = get_config(arch).reduced()
    model = build(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = init_opt_state(model)
    step = make_train_step(build(cfg, device=CPU), AdamWConfig(**OPT),
                           donate=False)
    new, st, _ = step(model, opt, _port(_np_batch(cfg)))
    assert new is not model and int(st["step"]) == 1
    assert int(opt["step"]) == 0
    assert all(torch.equal(p, before[n]) for n, p in
               model.named_parameters())
    assert any(not torch.equal(p, before[n]) for n, p in
               new.named_parameters())


def test_microbatch_accumulator_is_float32():
    """With bf16 weights each microbatch's gradient is taken in bf16 and
    summed into a float32 buffer, as the reference's f32 accumulator."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="bfloat16")
    model = build(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    seen = []
    from repro_torch.optim import adamw
    real = adamw.apply_updates

    def spy(params, grads, state, ocfg):
        seen.extend(g.dtype for g in grads.values())
        return real(params, grads, state, ocfg)
    adamw.apply_updates = spy
    try:
        make_train_step(build(cfg, device=CPU), AdamWConfig(**OPT),
                        microbatches=2)(model, init_opt_state(model),
                                        _port(_np_batch(cfg, B=4)))
    finally:
        adamw.apply_updates = real
    assert seen and set(seen) == {torch.float32}
    assert any(p.dtype == torch.bfloat16 for p in model.parameters())


# -------------------------------------------- the reference's tests, mirrored
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_and_train_step(arch):
    """Reduced config: one forward + one train step, shapes + no NaNs
    (the reference's ``tests/test_models.py`` smoke test)."""
    cfg = get_config(arch).reduced()
    m = build(cfg, device=CPU)
    params = m.init(torch.Generator().manual_seed(0))
    batch = _port(_np_batch(cfg, S=32))
    batch = {k: v.long() if not v.is_floating_point() else v
             for k, v in batch.items()}
    with torch.no_grad():
        h = m.forward(params, batch)
    S_out = 32 + (cfg.n_img_tokens if cfg.family == "vlm" else 0)
    assert h.shape == (2, S_out, cfg.d_model)
    assert bool(torch.isfinite(h).all())
    step = make_train_step(m, AdamWConfig(warmup_steps=0, total_steps=10),
                           donate=False)
    opt = init_opt_state(params)
    p2, o2, metrics = step(params, opt, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert int(o2["step"]) == 1
    assert any(not torch.equal(a, b) for a, b in
               zip(params.parameters(), p2.parameters()))


def test_train_then_serve_same_params(tmp_path):
    """Train a few steps, then serve with the restored params — the full
    lifecycle (the reference's ``tests/test_system.py``)."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model_zoo import load_tree
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("tinyllama-1.1b").reduced()
    bundle = build(cfg, device=CPU)
    tcfg = TrainerConfig(total_steps=3, ckpt_every=100, log_every=100,
                         ckpt_dir=str(tmp_path))
    dcfg = DataConfig(vocab=cfg.vocab, seq=16, global_batch=2)
    tr = Trainer(bundle, AdamWConfig(warmup_steps=0), tcfg, dcfg)
    trained, _ = tr.run()
    step, tree = CheckpointManager(str(tmp_path)).restore()
    assert step == 3
    served = bundle.init(None)
    load_tree(served, tree["params"])
    assert all(torch.equal(a, b) for a, b in
               zip(served.parameters(), trained.parameters()))
    eng = ServeEngine(bundle, slots=1, capacity=32)
    eng.load(served)
    req = Request(rid=0, prompt=np.asarray([1, 2, 3], np.int32), max_new=3)
    eng.submit(req)
    eng.run_until_done()
    assert len(req.out) == 3


def test_trainer_checkpoint_restores_through_tree_of(tmp_path):
    """``tree_of`` stacks a layer group as the reference stacks it."""
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build(cfg, device=CPU).init(torch.Generator().manual_seed(1))
    tree = tree_of(model, dict(model.named_parameters()))
    assert isinstance(tree["layers"]["wq"], list)
    assert len(tree["layers"]["wq"]) == cfg.n_layers
    assert tree["layers"]["wq"][1] is model.layers[1].wq


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "pixtral-12b",
                                  "whisper-small"])
def test_launcher_trains_on_the_cpu(arch, tmp_path, capsys):
    from repro_torch.launch.train import main
    steps = 6 if arch == "tinyllama-1.1b" else 2
    tr = main(["--arch", arch, "--preset", "cpu-ci", "--steps", str(steps),
               "--seq", "16", "--global-batch", "4", "--lr", "3e-3",
               "--fixed-batch", "--ckpt-dir", str(tmp_path),
               "--device", "cpu"])
    losses = [h["loss"] for h in tr.history]
    assert len(losses) == steps and all(np.isfinite(losses))
    assert tr.ckpt.latest_step() == steps
    if arch == "tinyllama-1.1b":
        assert losses[-1] < losses[0]
    assert "first loss" in capsys.readouterr().out


def test_launcher_full_preset_needs_the_production_grid(tmp_path):
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="256 ranks"):
        main(["--preset", "full", "--device", "cpu", "--ckpt-dir",
              str(tmp_path)])
