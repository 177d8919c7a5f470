"""repro_torch.models against the reference ``repro.models``.

Port vs reference, for every architecture of ``ARCH_IDS`` at ``reduced()``
(float32), on the reference's weights from ``PRNGKey(0)`` carried across
with ``params_from_numpy``: the forward's hidden states, the loss, the
prefill's logits and every cache leaf, and the logits of 8 decode steps.
The MoE configs run at their published ``capacity_factor`` (1.25), so the
tokens that drop past an expert's capacity must be the same ones (at
these inputs the forward overfills one expert of the first MoE layer by
one (token, k) entry; ``test_moe_dispatch_drops_the_reference_tokens``
drops a quarter of the entries).

Tolerance: 1e-5 of the largest magnitude of the compared value (float32
sums in another order: torch's einsum and matmul against XLA's).

Then the reference's own model tests (``tests/test_models.py``), mirrored
on the port with the reference's tolerances, and the device rule: a
bundle built with no device raises when there is no CUDA device.
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
from repro.models import moe as ref_moe
from repro.models.model_zoo import build as ref_build
from repro.models.transformer import logits_fn as ref_logits_fn
from repro_torch.configs.base import get_config
from repro_torch.models import moe
from repro_torch.models.model_zoo import build, params_from_numpy
from repro_torch.models.transformer import logits_fn

KEY = jax.random.PRNGKey(0)
RTOL = 1e-5          # of the largest magnitude: fp32 sums in another order
CPU = torch.device("cpu")


def _close(got, want, rtol=RTOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)
    return err / scale


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
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in b.items()}


def _pair(arch, **over):
    return _pair_cached(arch, tuple(sorted(over.items())))


@functools.lru_cache(maxsize=None)
def _pair_cached(arch, over):
    """(cfg, reference bundle, reference params, port bundle, port model)
    on the same weights; the reference's functions jitted (as its engine
    jits its decode), which only saves their per-op dispatch here."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **dict(over))
    rcfg = dataclasses.replace(ref_config(arch).reduced(), **dict(over))
    rm = ref_build(rcfg)
    rp = rm.init(KEY)
    rm = dataclasses.replace(rm, **{k: jax.jit(getattr(rm, k)) for k in (
        "forward", "loss", "prefill", "decode")})
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, rp),
                              device=CPU)
    return cfg, rm, rp, build(cfg, device=CPU), model


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# ------------------------------------------------------ port vs reference
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_matches_reference(arch):
    cfg, rm, rp, m, model = _pair(arch)
    B, S, P, steps = 2, 16, 8, 8
    nb = _np_batch(cfg, B, S)
    rb, pb = _ref(nb), _port(nb)
    with torch.inference_mode():
        _close(m.forward(model, pb), rm.forward(rp, rb), what="forward")
        _close(m.loss(model, pb), rm.loss(rp, rb), what="loss")

        extra = cfg.n_img_tokens if cfg.family == "vlm" else 0
        cap = S + extra + 2
        rpre = dict(rb, tokens=rb["tokens"][:, :P])
        ppre = dict(pb, tokens=pb["tokens"][:, :P])
        rlg, rcache = rm.prefill(rp, rpre, rm.init_cache(B, cap,
                                                         jnp.float32))
        lg, cache = m.prefill(model, ppre, m.init_cache(B, cap,
                                                        torch.float32))
        _close(lg, rlg, what="prefill logits")
        got, want = dict(_leaves(cache)), dict(_leaves(rcache))
        assert got.keys() == want.keys()
        for name in want:
            _close(got[name], want[name], what=f"prefill cache {name}")

        rlen = jnp.full((B,), P + extra, jnp.int32)
        plen = torch.full((B,), P + extra, dtype=torch.long)
        for t in range(P, P + steps):
            rlg, rcache = rm.decode(rp, rb["tokens"][:, t:t + 1], rcache,
                                    rlen)
            lg, cache = m.decode(model, pb["tokens"][:, t:t + 1], cache,
                                 plen)
            _close(lg, rlg, what=f"decode step {t}")
            rlen, plen = rlen + 1, plen + 1


BF16_RTOL = 3e-2     # bf16 rounding in another order: measured <= 2.0e-2


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-3b-a800m",
                                  "recurrentgemma-9b", "mamba2-370m"])
def test_bf16_casts_follow_reference(arch):
    """The published dtype (bf16) on the same weights: the hidden states
    stay bf16, the logits are float32 and every cache leaf has the
    reference's dtype, with values within BF16_RTOL of the largest.  (The
    hybrid's recurrent conv states are the exception: the reference's
    scan hands them back in the model's dtype, the port writes them into
    its float32 cache in place, ROADMAP §3 item 9; bf16 values, exactly
    held.)"""
    cfg, rm, rp, m, model = _pair(arch, dtype="bfloat16")
    nb = _np_batch(cfg, 2, 16)
    rb, pb = _ref(nb), _port(nb)
    with torch.inference_mode():
        h, rh = m.forward(model, pb), rm.forward(rp, rb)
        assert (h.dtype, str(rh.dtype)) == (torch.bfloat16, "bfloat16")
        _close(h, rh, BF16_RTOL, "forward")
        lg, cache = m.prefill(model, dict(pb, tokens=pb["tokens"][:, :8]),
                              m.init_cache(2, 20, torch.bfloat16))
    rlg, rcache = rm.prefill(rp, dict(rb, tokens=rb["tokens"][:, :8]),
                             rm.init_cache(2, 20, jnp.bfloat16))
    assert (lg.dtype, str(rlg.dtype)) == (torch.float32, "float32")
    _close(lg, rlg, BF16_RTOL, "prefill logits")
    want = dict(_leaves(rcache))
    for name, leaf in _leaves(cache):
        if not name.endswith(".conv") or cfg.family != "hybrid":
            assert str(leaf.dtype) == f"torch.{want[name].dtype}", name
        _close(leaf, want[name], BF16_RTOL, name)


def test_params_from_numpy_is_a_copy_by_name():
    """Every reference leaf lands in the port's parameter of the same
    name (a stacked leaf's layer i in ModuleList entry i), unchanged."""
    cfg, _, rp, _, model = _pair("recurrentgemma-9b")
    got = dict(model.named_parameters())
    n = 0
    for name, leaf in _leaves(jax.tree.map(np.asarray, rp)):
        top, _, rest = name.partition(".")
        if isinstance(getattr(model, top), torch.nn.ModuleList):
            for i in range(leaf.shape[0]):
                assert np.array_equal(got[f"{top}.{i}.{rest}"].detach(),
                                      leaf[i])
                n += 1
        else:
            assert np.array_equal(got[name].detach(), leaf)
            n += 1
    assert n == len(got)


def test_moe_dispatch_drops_the_reference_tokens():
    """A skewed router overfills expert 0: the port's dispatch drops the
    same (token, k) entries as the reference's and combines the rest to
    the same output."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    rcfg = ref_config("granite-moe-3b-a800m").reduced()
    rng = np.random.default_rng(11)
    T, D = 64, cfg.d_model
    rp = jax.tree.map(np.array, ref_moe.moe_init(KEY, rcfg, jnp.float32))
    rp["router"][:, 0] += 0.5           # most tokens pick expert 0
    xt = (1.0 + rng.standard_normal((T, D))).astype(np.float32)
    C = moe._capacity(T, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    want = ref_moe._dispatch_group(jnp.asarray(xt), rp, rcfg, C)
    p = moe.MoE(cfg, torch.float32)
    p.load_state_dict({k: torch.from_numpy(v) for k, v in rp.items()})
    with torch.inference_mode():
        got = moe._dispatch_group(torch.from_numpy(xt), p, cfg, C)
        logits = torch.from_numpy(xt) @ p.router
        top = moe._top_k(logits, cfg.top_k)[1].reshape(-1)
    assert int((torch.bincount(top, minlength=cfg.n_experts) > C).sum())
    _close(got, want, what="dispatch with drops")


def test_ctx_grid_sets_the_moe_groups():
    """``ctx`` answers sizes from the installed grid and places nothing:
    with a "model" axis that divides the expert count, ``moe_apply``
    routes per batch row (the reference's policy under a mesh, held here
    to the reference with ``groups=B``); with none installed, in one
    group, as on the serving path."""
    from repro_torch.core.grid import ProcGrid
    from repro_torch.sharding import ctx
    cfg = get_config("granite-moe-3b-a800m").reduced()
    rcfg = ref_config("granite-moe-3b-a800m").reduced()
    rp = jax.tree.map(np.array, ref_moe.moe_init(KEY, rcfg, jnp.float32))
    p = moe.MoE(cfg, torch.float32)
    p.load_state_dict({k: torch.from_numpy(v) for k, v in rp.items()})
    x = np.random.default_rng(4).standard_normal((3, 8, cfg.d_model)
                                                 ).astype(np.float32)
    grid = ProcGrid.create_abstract([2, 4], ["data", "model"])
    assert (ctx.axis_size("model"), ctx.batch_size(), ctx.active()) == \
        (None, None, False)
    with ctx.use(grid, ("data",)), torch.inference_mode():
        assert (ctx.axis_size("model"), ctx.axis_size("seq"),
                ctx.batch_size(), ctx.active()) == (4, None, 2, True)
        t = torch.from_numpy(x)
        assert ctx.constrain(t, "batch", None) is t
        assert ctx.constrain_act(t) is t and ctx.constrain_batch(t) is t
        rows = moe.moe_apply(p, t, cfg)
    with torch.inference_mode():
        one = moe.moe_apply(p, torch.from_numpy(x), cfg)
    _close(rows, ref_moe.moe_apply(rp, jnp.asarray(x), rcfg, groups=3))
    _close(one, ref_moe.moe_apply(rp, jnp.asarray(x), rcfg))


def test_top_k_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = moe._top_k(x, 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0] * 3]
    rv, ri = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert np.asarray(ri).tolist() == idx.tolist()


# ------------------------------------------ the reference's model tests
def _batch(cfg, B=2, S=32):
    return _port(_np_batch(cfg, B, S))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_teacher_forced(arch):
    """Token-by-token decode logits == full forward logits (per family);
    5e-5 as the reference's test."""
    cfg = get_config(arch).reduced()
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    m = build(cfg, device=CPU)
    B, S = 2, 16
    batch = _batch(cfg, B, S)
    with torch.inference_mode():
        params = m.init(torch.Generator().manual_seed(0))
        full = logits_fn(params, m.forward(params, batch), cfg)
        extra = cfg.n_img_tokens if cfg.family == "vlm" else 0
        P = S // 2
        cache = m.init_cache(B, S + extra + 2, torch.float32)
        lg, cache = m.prefill(params, dict(batch, tokens=batch["tokens"][
            :, :P]), cache)
        errs = [float((lg[:, 0] - full[:, extra + P - 1]).abs().max())]
        lengths = torch.full((B,), P + extra, dtype=torch.long)
        for t in range(P, S):
            lg, cache = m.decode(params, batch["tokens"][:, t:t + 1], cache,
                                 lengths)
            lengths = lengths + 1
            errs.append(float((lg[:, 0] - full[:, extra + t]).abs().max()))
    assert max(errs) < 5e-5, f"{arch}: {errs}"


def test_moe_capacity_drops_tokens_gracefully():
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              capacity_factor=0.5)
    m = build(cfg, device=CPU)
    with torch.inference_mode():
        params = m.init(torch.Generator().manual_seed(0))
        loss = m.loss(params, _batch(cfg))
    assert bool(torch.isfinite(loss))


def test_local_window_attention_masks_past():
    """A windowed attention is exactly invariant to keys/values beyond the
    window."""
    from repro_torch.models.attention import blocked_attention
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 24, 4, 8)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 24, 2, 8)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 24, 2, 8)).astype(
        np.float32))
    o1 = blocked_attention(q, k, v, causal=True, window=4, block=8)
    k2, v2 = k.clone(), v.clone()
    k2[:, :8] = 0.0
    v2[:, :8] = 0.0
    o2 = blocked_attention(q, k2, v2, causal=True, window=4, block=8)
    np.testing.assert_allclose(o1[:, 16:].numpy(), o2[:, 16:].numpy(),
                               atol=1e-6)


def test_blocked_attention_matches_naive():
    from repro_torch.models.attention import blocked_attention
    rng = np.random.default_rng(5)
    B, S, H, Kh, D = 2, 32, 4, 2, 8
    q = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, Kh, D)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, Kh, D)).astype(
        np.float32))
    o = blocked_attention(q, k, v, causal=True, block=8)
    kr = torch.repeat_interleave(k, H // Kh, 2)
    vr = torch.repeat_interleave(v, H // Kh, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(D)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool))
    s = torch.where(mask[None, None], s, -1e30)
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vr)
    np.testing.assert_allclose(o.numpy(), ref.numpy(), atol=2e-5)


def test_decode_attention_gqa_matches_prefill_heads():
    """The factored decode maps head h to KV head h // G, as prefill's
    repeat_interleave does: the last query row of a causal prefill equals
    the decode against the same cache."""
    from repro_torch.models.attention import blocked_attention, \
        decode_attention
    rng = np.random.default_rng(9)
    B, S, H, Kh, D = 2, 12, 6, 2, 8
    q = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, Kh, D)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, Kh, D)).astype(
        np.float32))
    full = blocked_attention(q, k, v, causal=True)
    one = decode_attention(q[:, -1:], k, v, torch.full((B,), S))
    np.testing.assert_allclose(one.numpy(), full[:, -1:].numpy(),
                               atol=1e-6)


def test_ssd_chunked_matches_sequential_scan():
    """Mamba-2 SSD chunked dual form vs naive recurrence."""
    from repro_torch.models.ssm import ssd_chunked
    rng = np.random.default_rng(6)
    B, S, H, P, N = 1, 32, 2, 4, 8
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.abs(rng.standard_normal((B, S, H))).astype(np.float32) * 0.5
    A = -np.abs(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    y = ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), 8).numpy()
    s = np.zeros((B, H, N, P), np.float32)
    ref = np.zeros_like(x)
    for t in range(S):
        dA = np.exp(dt[:, t] * A)                       # (B,H)
        s = s * dA[..., None, None] + np.einsum(
            "bn,bh,bhp->bhnp", Bm[:, t], dt[:, t], x[:, t])
        ref[:, t] = np.einsum("bn,bhnp->bhp", Cm[:, t], s)
    np.testing.assert_allclose(y, ref, rtol=1e-3, atol=1e-3)


def test_rglru_scan_matches_sequential():
    from repro_torch.models.rglru import RGLRU, rglru_block, \
        rglru_init_state
    cfg = get_config("recurrentgemma-9b").reduced()
    p = RGLRU(cfg, torch.float32, gen=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 12, cfg.d_model)).astype(
        np.float32))
    with torch.inference_mode():
        y_par, _ = rglru_block(p, x, cfg)
        st = rglru_init_state(cfg, 2)
        outs = []
        for t in range(12):
            y, st = rglru_block(p, x[:, t:t + 1], cfg, state=st)
            outs.append(y.numpy())
    np.testing.assert_allclose(y_par.numpy(), np.concatenate(outs, 1),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S", [1, 2, 5, 8, 13])
def test_affine_scan_matches_the_loop(S):
    """The doubling scan against h_t = a_t h_{t-1} + b_t, step by step,
    at lengths that are and are not powers of two."""
    from repro_torch.models.rglru import affine_scan
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0.1, 1.0, (2, S, 3)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((2, S, 3)).astype(np.float32))
    _, hs = affine_scan(a, b)
    h = torch.zeros(2, 3)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(hs[:, t].numpy(), h.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_param_counts_match_analytic():
    for arch in ["tinyllama-1.1b", "mamba2-370m"]:
        cfg = get_config(arch).reduced()
        params = build(cfg, device=CPU).init(torch.Generator().manual_seed(0))
        actual = sum(p.numel() for p in params.parameters())
        est = cfg.param_count()
        assert abs(actual - est) / actual < 0.05, (arch, actual, est)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_reference_tree(arch):
    """The port's model holds as many parameters as the reference's tree
    (the shapes themselves are checked by ``load_state_dict``)."""
    cfg, _, rp, _, model = _pair(arch)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in jax.tree.leaves(rp))


def test_fft_conv_option_for_mamba():
    """conv_impl='fft' (the port's fft_conv) ≡ direct conv (2e-3, as the
    reference's test)."""
    cfg = get_config("mamba2-370m").reduced()
    m1 = build(cfg, device=CPU)
    b = _batch(cfg, 2, 16)
    with torch.inference_mode():
        params = m1.init(torch.Generator().manual_seed(0))
        h1 = m1.forward(params, b)
        m2 = build(dataclasses.replace(cfg, conv_impl="fft"), device=CPU)
        h2 = m2.forward(params, b)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_fft_conv_route_matches_reference():
    """With conv_impl='fft' the port's forward agrees with the reference's
    fft route (its "jnp" fft_conv) at 1e-5 of the largest value."""
    cfg, rm, rp, m, model = _pair("mamba2-370m", conv_impl="fft")
    nb = _np_batch(cfg, 2, 16)
    with torch.inference_mode():
        _close(m.forward(model, _port(nb)), rm.forward(rp, _ref(nb)))


def test_build_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tinyllama-1.1b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(cfg)
    assert build(cfg, device="cpu").device == CPU


def test_ref_logits_fn_matches():
    """``logits_fn`` casts the weight to h's dtype, then the product to
    float32, as the reference's."""
    cfg, _, rp, _, model = _pair("granite-3-2b")
    h = np.random.default_rng(3).standard_normal((2, 3, cfg.d_model)
                                                 ).astype(np.float32)
    with torch.inference_mode():
        got = logits_fn(model, torch.from_numpy(h), cfg)
    assert got.dtype == torch.float32
    _close(got, ref_logits_fn(rp, jnp.asarray(h), cfg))
