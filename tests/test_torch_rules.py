"""repro_torch.sharding.rules against the reference ``repro.sharding.rules``.

``param_specs`` of every ``ARCH_IDS`` model at its published shapes (the
port's model built on the ``meta`` device, the reference's from
``jax.eval_shape``) on the abstract single-pod (16×16) and multi-pod
(2×16×16) grids: each port parameter gets exactly the spec of its
reference leaf, a stacked layer leaf's leading ``None`` included.  Then
``drop_indivisible``, ``batch_axis``, ``data_specs`` and ``cache_specs``
against the reference on the same inputs, and the reference's own rule
tests (``tests/test_sharding.py``) mirrored.  Specs compare as tuples
(``tuple(PartitionSpec)``); no tolerance.
"""
import functools

import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.configs.base import ARCH_IDS, SHAPES
from repro.configs.base import get_config as ref_config
from repro.core.compat import abstract_mesh
from repro.models.model_zoo import build as ref_build
from repro.sharding import rules as ref_rules
from repro_torch.configs.base import get_config
from repro_torch.core.grid import ProcGrid
from repro_torch.models.model_zoo import build, reference_name, \
    stacked_lists
from repro_torch.sharding import rules

KEY = jax.random.PRNGKey(0)
GRIDS = {"single": ((16, 16), ("data", "model")),
         "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _grid(name):
    return ProcGrid.create_abstract(*GRIDS[name])


def _mesh(name):
    return abstract_mesh(*GRIDS[name])


@functools.lru_cache(maxsize=None)
def _models(arch):
    model = build(get_config(arch), device="meta").init(None)
    shapes = jax.eval_shape(ref_build(ref_config(arch)).init, KEY)
    return model, shapes


def _ref_flat(specs) -> dict:
    return {".".join(k.key for k in path): tuple(s) for path, s in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, P))[0]}


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, grid):
    model, shapes = _models(arch)
    want = _ref_flat(ref_rules.param_specs(shapes, _mesh(grid)))
    got = rules.param_specs(model, _grid(grid))
    lists = stacked_lists(model)
    assert set(got) == {n for n, _ in model.named_parameters()}
    seen = set()
    for name, spec in got.items():
        ref, _ = reference_name(name, lists)
        assert spec == want[ref], (name, spec, want[ref])
        seen.add(ref)
    assert seen == set(want)


_DROP_CASES = [
    (("model", "data"), (49155, 2048)), (("model", "data"), (32000, 2048)),
    ((("pod", "data"), None), (64, 8)), (("pod", "data"), (64, 8)),
    ((None, "model", None), (4, 40, 8)), (("data",), (3,)), ((), (5, 5))]


@pytest.mark.parametrize("grid,spec,shape", [
    (g, spec, shape) for g in GRIDS for spec, shape in _DROP_CASES
    if g == "multi" or "pod" not in str(spec)])      # single has no pod
def test_drop_indivisible_equals_the_reference(grid, spec, shape):
    got = rules.drop_indivisible(spec, shape, _grid(grid))
    want = ref_rules.drop_indivisible(P(*spec), shape, _mesh(grid))
    assert got == tuple(want)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("batch", [1, 16, 17, 32, 256, 512])
def test_batch_axis_equals_the_reference(batch, grid):
    assert rules.batch_axis(_grid(grid), batch) == \
        ref_rules.batch_axis(_mesh(grid), batch)


@pytest.mark.parametrize("arch", ["pixtral-12b", "whisper-small",
                                  "tinyllama-1.1b"])
def test_data_specs_equal_the_reference(arch):
    shape = SHAPES[next(iter(SHAPES))]
    got = rules.data_specs(get_config(arch), shape, _grid("multi"))
    want = ref_rules.data_specs(ref_config(arch), shape, _mesh("multi"))
    assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-370m",
                                  "recurrentgemma-9b", "whisper-small",
                                  "qwen3-32b"])
def test_cache_specs_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    cache = build(cfg, device="meta").init_cache(128, 64, torch.bfloat16)
    rcache = jax.eval_shape(lambda: ref_build(rcfg).init_cache(
        128, 64, jnp.bfloat16))
    got = rules.cache_specs(cfg, 128, _grid("single"), cache)
    want = ref_rules.cache_specs(rcfg, 128, _mesh("single"), rcache)
    flat = {".".join(k.key for k in path): s for path, s in
            jax.tree_util.tree_flatten_with_path(
                got, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert flat == _ref_flat(want)


# ------------------------------------------- the reference's tests, mirrored
def test_param_specs_tp_fsdp():
    model, _ = _models("tinyllama-1.1b")
    specs = rules.param_specs(model, _grid("single"))
    assert specs["embed"] == ("model", "data")
    assert specs["layers.0.wq"] == (None, "data", "model")
    assert specs["layers.3.wo"] == (None, "model", "data")
    assert specs["layers.0.mlp.w_down"] == (None, "model", "data")
    assert specs["layers.0.ln1"] == ()


def test_fsdp_spans_pods_on_multipod():
    model, _ = _models("tinyllama-1.1b")
    specs = rules.param_specs(model, _grid("multi"))
    assert specs["layers.0.wq"] == (None, ("pod", "data"), "model")
    assert specs["embed"] == ("model", ("pod", "data"))


def test_indivisible_vocab_replicated():
    model, _ = _models("granite-3-2b")        # vocab 49155: not /16
    specs = rules.param_specs(model, _grid("single"))
    assert specs["embed"] == (None, "data")


def test_moe_expert_parallel():
    model, _ = _models("dbrx-132b")
    specs = rules.param_specs(model, _grid("single"))
    assert specs["layers.0.moe.w_up"] == (None, "model", "data", None)
    assert specs["layers.0.moe.w_down"] == (None, "model", None, "data")


def test_batch_axis_divisibility():
    assert rules.batch_axis(_grid("single"), 256) == ("data",)
    assert rules.batch_axis(_grid("multi"), 256) == ("pod", "data")
    assert rules.batch_axis(_grid("multi"), 1) is None
    assert rules.batch_axis(_grid("multi"), 17) is None


def test_cache_specs_kv_fallback():
    cfg = get_config("tinyllama-1.1b")      # kv=4: not /16 → shard hd=64
    cache = build(cfg, device="meta").init_cache(128, 64, torch.bfloat16)
    specs = rules.cache_specs(cfg, 128, _grid("single"), cache)
    assert specs["k"] == (None, "data", None, None, "model")


def test_drop_indivisible():
    s = rules.drop_indivisible(("model", "data"), (49155, 2048),
                               _grid("single"))
    assert s == (None, "data")
    s2 = rules.drop_indivisible((("pod", "data"), None), (64, 8),
                                _grid("multi"))
    assert s2 == (("pod", "data"), None)


def test_production_grid_needs_its_ranks():
    """``make_production_grid`` raises without 256 (512) ranks, as the
    reference's ``make_production_mesh`` raises without its devices."""
    from repro_torch.launch.mesh import make_host_grid, \
        make_production_grid
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="ranks"):
            make_production_grid(multi_pod=multi, device="cpu")
    g = make_host_grid((1, 1), device="cpu")
    assert g.axes == ("data", "model") and g.shape == (1, 1)


def test_axes_the_grid_lacks_split_nothing():
    """On a data-only grid (a data-parallel run) the "model" entries are
    dropped (the reference's mesh lookup would raise there)."""
    model, _ = _models("tinyllama-1.1b")
    grid = ProcGrid.create_abstract((2,), ("data",))
    specs = rules.param_specs(model, grid)
    assert specs["embed"] == (None, "data")
    assert specs["layers.0.wq"] == (None, "data", None)
    assert specs["layers.0.ln1"] == ()
    assert rules.drop_indivisible((("pod", "data"), "model"), (8, 8),
                                  grid) == ("data", None)
