"""repro_torch.serve.engine (continuous batching) and the serve launcher.

The reference's engine tests (``tests/test_serve.py``) on the port, then
the port's engine against the reference's engine on the same weights and
requests (2 slots, 5 requests, so slots are reused): the generated tokens
must be equal.  Greedy tokens follow the largest logit, so at every
prefill and decode step the test asserts that the reference's top-2
logit gap of every active slot exceeds ``MIN_GAP``: a near-tie would flip
on rounding and show as a fault of the test data, not of the port.
"""
import dataclasses
from collections import deque

import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_config as ref_config
from repro.models.model_zoo import build as ref_build
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.configs.base import get_config
from repro_torch.models.model_zoo import build, params_from_numpy
from repro_torch.models.transformer import logits_fn
from repro_torch.serve.engine import Request, ServeEngine

CPU = torch.device("cpu")
MIN_GAP = 1e-3


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tinyllama-1.1b").reduced()
    bundle = build(cfg, device=CPU)
    with torch.inference_mode():
        params = bundle.init(torch.Generator().manual_seed(0))
    return cfg, bundle, params


def _greedy_ref(cfg, bundle, params, prompt, n_new):
    """Reference: repeated full forward + argmax (no cache)."""
    toks = list(prompt)
    with torch.inference_mode():
        for _ in range(n_new):
            h = bundle.forward(params, {"tokens": torch.tensor([toks])})
            lg = logits_fn(params, h[:, -1:], cfg)
            toks.append(int(torch.argmax(lg[0, -1])))
    return toks[len(prompt):]


def test_engine_matches_uncached_greedy(tiny):
    cfg, bundle, params = tiny
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, 6, dtype=np.int32)
    eng = ServeEngine(bundle, slots=1, capacity=64)
    eng.load(params)
    req = Request(rid=0, prompt=prompt, max_new=5)
    eng.submit(req)
    eng.run_until_done()
    ref = _greedy_ref(cfg, bundle, params, prompt.tolist(), 5)
    assert req.out[:5] == ref


def test_continuous_batching_more_requests_than_slots(tiny):
    cfg, bundle, params = tiny
    rng = np.random.default_rng(1)
    eng = ServeEngine(bundle, slots=2, capacity=64)
    eng.load(params)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 4,
                                               dtype=np.int32), max_new=4)
            for i in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    assert all(len(r.out) == 4 for r in reqs)
    # batching must not change results vs serving each alone
    solo = ServeEngine(bundle, slots=1, capacity=64)
    solo.load(params)
    r0 = Request(rid=99, prompt=reqs[0].prompt, max_new=4)
    solo.submit(r0)
    solo.run_until_done()
    assert r0.out == reqs[0].out


def test_cache_dtype_respected_by_prefill_splice(tiny):
    """The per-slot prefill cache uses the engine's cache_dtype: with a
    bf16 engine nothing in the KV cache round-trips through f32."""
    cfg, bundle, params = tiny
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab, 5, dtype=np.int32)
    seen = []

    def spy(batch, capacity, dtype):
        seen.append((batch, dtype))
        return bundle.init_cache(batch, capacity, dtype)

    spied = dataclasses.replace(bundle, init_cache=spy)
    eng = ServeEngine(spied, slots=1, capacity=64,
                      cache_dtype=torch.bfloat16)
    assert eng.cache_dtype == torch.bfloat16
    eng.load(params)
    eng.submit(Request(rid=0, prompt=prompt, max_new=2))
    eng.run_until_done()
    # both the batched cache and every per-slot prefill cache: bf16
    assert len(seen) >= 2
    assert all(dt == torch.bfloat16 for _, dt in seen)
    assert all(leaf.dtype == torch.bfloat16 for leaf in eng.cache.values())


def test_queue_is_deque_and_mask_tracks_active(tiny):
    """Admission queue pops from the left in O(1); the per-step lengths
    increment comes from the maintained active-slot mask."""
    cfg, bundle, params = tiny
    rng = np.random.default_rng(4)
    eng = ServeEngine(bundle, slots=2, capacity=64)
    eng.load(params)
    assert isinstance(eng.queue, deque)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 4,
                                               dtype=np.int32), max_new=3)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    # two admitted (FIFO), one still queued; mask mirrors active slots
    assert [r.rid for r in eng.queue] == [2]
    assert sorted(eng._active_mask.tolist()) == [1, 1]
    assert set(np.flatnonzero(eng._active_mask)) == set(eng.active)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    assert eng._active_mask.tolist() == [0, 0]
    # lengths advanced once per active step: prompt + generated - 1
    assert eng.lengths.tolist() == [4 + 3 - 1, 4 + 3 - 1]


def test_slot_reuse(tiny):
    cfg, bundle, params = tiny
    rng = np.random.default_rng(2)
    eng = ServeEngine(bundle, slots=1, capacity=64)
    eng.load(params)
    a = Request(rid=0, prompt=rng.integers(0, cfg.vocab, 4,
                                           dtype=np.int32), max_new=3)
    b = Request(rid=1, prompt=rng.integers(0, cfg.vocab, 4,
                                           dtype=np.int32), max_new=3)
    eng.submit(a)
    eng.submit(b)
    eng.run_until_done()
    assert a.done and b.done
    assert eng.free == [0]


def test_request_past_the_capacity_is_refused(tiny):
    """A request whose prompt and new tokens overflow a slot's cache is
    refused at submit (the port's cache writes cannot drop silently)."""
    cfg, bundle, params = tiny
    eng = ServeEngine(bundle, slots=1, capacity=16)
    eng.load(params)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(Request(rid=0, prompt=np.zeros(10, np.int32),
                           max_new=7))
    eng.submit(Request(rid=1, prompt=np.zeros(10, np.int32), max_new=6))
    eng.run_until_done()
    assert eng.steps == 5


# ------------------------------------------------ port vs reference engine
def _top2_gap(logits, rows):
    top2 = np.sort(np.asarray(logits, np.float32)[rows], axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-370m",
                                  "granite-moe-3b-a800m"])
def test_engine_matches_reference_engine(arch):
    cfg = get_config(arch).reduced()
    rcfg = ref_config(arch).reduced()
    rbundle = ref_build(rcfg)
    rparams = rbundle.init(jax.random.PRNGKey(0))
    gaps = []

    def prefill_spy(params, batch, cache):
        lg, cache = rbundle.prefill(params, batch, cache)
        gaps.append(_top2_gap(lg[0, -1], ...))
        return lg, cache

    ref = RefEngine(dataclasses.replace(rbundle, prefill=prefill_spy),
                    slots=2, capacity=32)
    ref.load(rparams)
    decode = ref._decode

    def decode_spy(params, toks, cache, lengths):
        active = sorted(ref.active)
        lg, cache = decode(params, toks, cache, lengths)
        gaps.append(_top2_gap(lg[:, 0], active))
        return lg, cache

    ref._decode = decode_spy
    eng = ServeEngine(build(cfg, device=CPU), slots=2, capacity=32)
    eng.load(params_from_numpy(cfg, jax.tree.map(np.asarray, rparams),
                               device=CPU))
    rng = np.random.default_rng(5)
    lens = rng.integers(3, 9, 5)
    news = rng.integers(3, 7, 5)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in lens]
    mine = [Request(rid=i, prompt=p, max_new=int(k))
            for i, (p, k) in enumerate(zip(prompts, news))]
    theirs = [RefRequest(rid=i, prompt=p, max_new=int(k))
              for i, (p, k) in enumerate(zip(prompts, news))]
    for a, b in zip(mine, theirs):
        eng.submit(a)
        ref.submit(b)
    eng.run_until_done()
    ref.run_until_done()
    assert min(gaps) > MIN_GAP, ("near-tie in the test data", min(gaps))
    assert [r.out for r in mine] == [r.out for r in theirs]
    assert all(r.done for r in mine) and eng.steps == ref.steps
    assert eng.lengths.tolist() == np.asarray(ref.lengths).tolist()


def test_launcher_serves_every_request(capsys):
    from repro_torch.launch.serve import main
    reqs = main(["--device", "cpu", "--arch", "granite-moe-3b-a800m",
                 "--requests", "3", "--max-new", "4"])
    assert len(reqs) == 3 and all(r.done and len(r.out) == 4 for r in reqs)
    assert "served 3 requests" in capsys.readouterr().out


def test_launcher_defaults_to_the_card(monkeypatch):
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--requests", "1"])
