"""repro_torch.launch.dryrun against the reference ``repro.launch.dryrun``.

The port's dry run is an accounting on the ``meta`` device; the
reference's compiles XLA programs.  What the two share is held equal
here, with no tolerance: the cells' input shapes (ids int64 in the port,
int32 in the reference), the HLO collective parser, the parameter counts
and per-device parameter bytes under each side's ``param_specs`` on the
abstract production grids, and the paper cell's plan (stages and
communication bytes).  The rest is held to counts written out from
shapes: the sizing rules, the train step's matmul FLOPs, each modelled
collective term on a 2×2 grid, and the L=1/L=2 extrapolation against the
full-depth count.
"""
import dataclasses
import functools
import json
import math
import os
import types

import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.configs.base import ARCH_IDS, SHAPES
from repro.configs.base import applicable as ref_applicable
from repro.configs.base import get_config as ref_config
from repro.core import ProcGrid as RefProcGrid
from repro.core import SphereDomain as RefSphereDomain
from repro.core import make_planewave_pair as ref_make_planewave_pair
from repro.core.compat import abstract_mesh
from repro.models.model_zoo import build as ref_build
from repro.sharding import rules as ref_rules
from repro_torch.configs.base import Shape, get_config
from repro_torch.core.grid import ProcGrid
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_abstract_production_grid
from repro_torch.models.model_zoo import build
from repro_torch.train.train_step import init_opt_state

GRIDS = {"single": ((16, 16), ("data", "model")),
         "multi": ((2, 16, 16), ("pod", "data", "model"))}
HLO = """
  %ar = f32[128,256]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[64,512]{1,0} all-gather(%y), replica_groups=[2,8]<=[16], dimensions={0}
  %a2a = f32[32,32]{1,0} all-to-all(%z), replica_groups={{0,1},{2,3}}
  %cp = (f32[16,16]{1,0}, f32[16,16]{1,0}) collective-permute-start(%w), source_target_pairs={{0,1}}
  %other = f32[9,9] add(%a, %b)
"""
HLO2 = """
  %rs = bf16[8,1024]{1,0} reduce-scatter(%g), replica_groups=[16,16]<=[256], dimensions={0}, to_apply=%add
  %ags = (bf16[4,64]{1,0}, bf16[16,64]{1,0}) all-gather-start(%p), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar2 = (f32[10]{0}, s32[3,3]{1,0}) all-reduce(%a, %b), replica_groups={}, to_apply=%add
  %a2a2 = c64[2,128,128]{2,1,0} all-to-all(%c), replica_groups=[32,16]<=[512], dimensions={1}
"""


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference module; importing it sets XLA_FLAGS to force 512
    host devices, which is put back at once (the worker's JAX backend
    must keep the suite's device count)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


def _abstract(name):
    return ProcGrid.create_abstract(*GRIDS[name])


# --------------------------------------------------------------- inputs
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch, shape, ref_dryrun):
    want = ref_dryrun.input_specs(arch, shape)
    got = dryrun.input_specs(arch, shape)
    assert set(got) == set(want)
    dtypes = {jnp.int32: torch.int64, jnp.bfloat16: torch.bfloat16}
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].dtype == dtypes[w.dtype.type], k
        assert got[k].device.type == "meta"


@pytest.mark.parametrize("hlo", [HLO, HLO2], ids=["reference_test", "more"])
def test_collective_bytes_equals_the_reference(hlo, ref_dryrun):
    got = dryrun.collective_bytes(hlo)
    assert got == ref_dryrun.collective_bytes(hlo)
    assert any(got.values())


# ------------------------------------------------ parameters and specs
@functools.lru_cache(maxsize=None)
def _models(arch):
    model = build(get_config(arch), device="meta").init(None)
    shapes = jax.eval_shape(ref_build(ref_config(arch)).init,
                            jax.random.PRNGKey(0))
    return model, shapes


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_and_bytes_per_device_equal_the_reference(arch, grid):
    model, shapes = _models(arch)
    mesh = abstract_mesh(*GRIDS[grid])
    specs = ref_rules.param_specs(shapes, mesh)
    leaves = jax.tree.leaves(shapes)
    want_bytes = 0
    for leaf, spec in zip(leaves, jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, P))):
        split = math.prod(mesh.shape[a] for e in spec if e is not None
                          for a in (e if isinstance(e, tuple) else (e,)))
        want_bytes += leaf.size * leaf.dtype.itemsize // split
    got = dryrun.param_leaves(model, _abstract(grid))
    assert sum(math.prod(lf["shape"]) for lf in got) == \
        sum(leaf.size for leaf in leaves)
    assert len(got) == len(leaves)
    assert dryrun.state_bytes(got, _abstract(grid), kind="decode")[
        "params"] == want_bytes


def test_abstract_production_grids_match_the_reference_mesh():
    for multi, name in ((False, "single"), (True, "multi")):
        g = make_abstract_production_grid(multi_pod=multi)
        assert (g.shape, g.axes) == GRIDS[name] and g.is_abstract
        mesh = abstract_mesh(*GRIDS[name])
        assert tuple(mesh.axis_names) == g.axes
        assert tuple(mesh.shape[a] for a in g.axes) == g.shape


# ----------------------------------------------------------- sizing rules
@pytest.mark.parametrize("arch,grid,mb,opt", [
    # qwen3-32b: d_model 5120 < 8192, so 16384 tokens a microbatch; its
    # 30.5e9 parameters × 10 B / 256 = 1.19e9 B < 6.5 GiB: float32
    ("qwen3-32b", "single", 16 * 4096 // 16384, torch.float32),
    ("qwen3-32b", "multi", 8 * 4096 // 16384, torch.float32),
    # nemotron-4-340b: d_model 18432, 4096 tokens; 341e9 × 10 / 256 =
    # 13.3e9 B > 6.5 GiB = 6.98e9 (bfloat16), / 512 = 6.66e9 B (float32)
    ("nemotron-4-340b", "single", 16 * 4096 // 4096, torch.bfloat16),
    ("nemotron-4-340b", "multi", 8 * 4096 // 4096, torch.float32)])
def test_sizing_rules_give_the_hand_computed_answers(arch, grid, mb, opt):
    cfg = get_config(arch)
    g = _abstract(grid)
    assert dryrun.microbatch_count(cfg, SHAPES["train_4k"], g) == mb
    n = sum(p.numel() for p in _models(arch)[0].parameters())
    assert dryrun.opt_state_dtype(n, g.nprocs) == opt


def test_microbatch_count_divides_the_local_batch():
    # 24 rows of 4096 tokens at 16384 a microbatch: 6 would be the count,
    # which divides 24; 20 rows give 5, which divides 20; 18 give 4 → 3
    cfg = get_config("tinyllama-1.1b")
    g = ProcGrid.create_abstract((1, 1), ("data", "model"))
    for rows, mb in ((24, 6), (20, 5), (18, 3)):
        assert dryrun.microbatch_count(
            cfg, Shape("t", "train", 4096, rows), g) == mb


# ------------------------------------------------------------- counting
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-3b-a800m",
                                  "mamba2-370m"])
def test_counted_flops_equal_flop_counter_mode(arch, kind):
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import make_train_step
    cfg = get_config(arch).reduced()
    got = dryrun.count_pass(cfg, kind, 4, 32, microbatches=2
                            if kind == "train" else 1)
    bundle, params = dryrun._meta_model(cfg)
    ins = dryrun._inputs(cfg, kind, 4, 32)
    with torch.inference_mode():
        cache = bundle.init_cache(4, 32, torch.bfloat16)
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            make_train_step(bundle, AdamWConfig(), microbatches=2)(
                params, init_opt_state(params), ins)
        else:
            with torch.inference_mode():
                if kind == "prefill":
                    bundle.prefill(params, ins, cache)
                else:
                    bundle.decode(params, ins["tokens"], cache,
                                  ins["lengths"])
    assert got["flops"] == fc.get_total_flops() > 0
    assert got["bytes_accessed"] > 0 and got["ops"] > 0
    assert (got["saved_bytes"] > 0) == (kind == "train")


def test_train_step_matmul_flops_equal_the_hand_count():
    """A reduced dense step (remat "none", one microbatch of B × S):
    every layer product runs three times (forward, and the two products
    of its backward), the head four (the loss chunk is rematerialised)."""
    cfg = get_config("tinyllama-1.1b").reduced()
    B, S = 2, 32
    D, H, Kh, hd, F, V = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                          cfg.d_ff, cfg.vocab)
    T = B * S
    proj = 2 * T * (D * H * hd + 2 * D * Kh * hd + H * hd * D + 3 * D * F)
    attn = 2 * 2 * B * H * S * S * hd         # scores and p·v, one block
    head = 2 * T * D * V
    want = 3 * cfg.n_layers * (proj + attn) + 4 * head
    got = dryrun.count_pass(cfg, "train", B, S)
    assert got["flops"] == want


def test_state_bytes_equal_the_tensors_of_a_train_step():
    """On one device, the accounting's state is the model's parameters,
    one set of gradients in their dtype, the float32 accumulator (two
    microbatches) and the AdamW state, to the byte."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="bfloat16")
    params = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    opt = init_opt_state(params)
    g1 = ProcGrid.create_abstract((1, 1), ("data", "model"))
    got = dryrun.state_bytes(dryrun.param_leaves(params, g1), g1,
                             kind="train", microbatches=2)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    plist = list(params.parameters())
    assert got["params"] == got["grads"] == nbytes(plist)
    assert got["accumulator"] == 4 * sum(p.numel() for p in plist)
    assert got["opt_state"] == nbytes(
        [*opt["m"].values(), *opt["v"].values(), opt["step"]])


@pytest.mark.parametrize("arch,layers", [
    ("tinyllama-1.1b", 4), ("granite-moe-3b-a800m", 3),
    ("recurrentgemma-9b", 6)])
def test_account_cell_extrapolation_equals_full_depth(arch, layers):
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=layers)
    shape = Shape("tiny_train", "train", 64, 8)
    g = ProcGrid.create_abstract((2, 2), ("data", "model"))
    passes = {}
    acct = dryrun.account_cell(arch, shape, g, verbose=False,
                               cfg_override=cfg, passes=passes)
    full = dryrun.lower_cell(arch, shape, g, verbose=False,
                             cfg_override=cfg, passes=passes)
    assert acct["l_full"] == (layers // 3 if cfg.family == "hybrid"
                              else layers)
    for key in ("flops", "bytes_accessed", "collective_total"):
        assert acct[key] == pytest.approx(full[key], rel=1e-12), key
    assert acct["collective_bytes"] == full["collective_bytes"]
    assert full["flops"] > 0


# ---------------------------------------------------------- collectives
G22 = ProcGrid.create_abstract((2, 2), ("data", "model"))
# (L=3, in 8, out 6) row-parallel bf16: split 4 ways (model 2 × data 2);
# a replicated norm; MoE experts (L=3, E=4, D=6, F=10) over model, D over
# data; an encoder row-parallel leaf (L=2)
LEAVES = [
    {"path": ("layers", "wo"), "shape": (3, 8, 6), "itemsize": 2,
     "spec": (None, "model", "data")},
    {"path": ("layers", "ln1"), "shape": (3, 6), "itemsize": 2, "spec": ()},
    {"path": ("layers", "moe", "w_up"), "shape": (3, 4, 6, 10),
     "itemsize": 2, "spec": (None, "model", "data", None)},
    {"path": ("enc_layers", "wo"), "shape": (2, 8, 6), "itemsize": 2,
     "spec": (None, "model", "data")}]


def test_fsdp_all_gather_hand_count():
    # each FSDP leaf's shard: 288/4, 1440/4, 192/4; 3 passes × 2 mb
    assert dryrun.fsdp_all_gather(LEAVES, G22, passes=3, microbatches=2) \
        == 3 * 2 * (72 + 360 + 48)


def test_grad_reduce_scatter_hand_count():
    # result × participants = bytes over the model split: 288/2, 1440/2,
    # 192/2, once a microbatch
    assert dryrun.grad_reduce_scatter(LEAVES, G22, microbatches=2) == \
        2 * (144 + 720 + 96)


def test_grad_all_reduce_hand_count():
    # the norm (18 elements, float32) and the loss
    assert dryrun.grad_all_reduce(LEAVES, G22, batch_split=True) == \
        4 * 18 + 4
    assert dryrun.grad_all_reduce(LEAVES, G22, batch_split=False) == 0


def test_tp_all_reduce_hand_count():
    # wo: 3 layers × 5 tokens × 6 outputs × 2 B; encoder wo: 2 × 7 × 6 × 2
    assert dryrun.tp_all_reduce(LEAVES, G22, passes=3, microbatches=2,
                                tokens=5, enc_tokens=7, act_bytes=2) == \
        3 * 2 * (3 * 5 * 6 * 2 + 2 * 7 * 6 * 2)


def test_ep_all_to_all_hand_count():
    cfg = types.SimpleNamespace(top_k=2, d_model=6)
    # dispatch and combine, 3 layers × 5 tokens × top-2 × 6 × 2 B
    assert dryrun.ep_all_to_all(LEAVES, G22, cfg, passes=3, microbatches=2,
                                tokens=5, act_bytes=2) == \
        2 * 3 * 2 * (3 * 5 * 2 * 6 * 2)


def test_score_all_reduce_hand_count():
    # one KV head does not split 2 ways: the cache splits head_dim, and
    # each decode step all-reduces 2 layers × B 2 × 4 heads × 16 × 4 B
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              n_kv=1)
    assert dryrun.score_all_reduce(cfg, G22, batch=2, capacity=16) == \
        2 * 2 * 4 * 16 * 4
    assert dryrun.score_all_reduce(get_config("tinyllama-1.1b").reduced(),
                                   G22, batch=2, capacity=16) == 0


def test_model_collectives_sum_the_terms():
    cfg = get_config("granite-moe-3b-a800m").reduced()
    model = build(cfg, device="meta").init(None)
    leaves = dryrun.param_leaves(model, G22)
    got = dryrun.model_collectives(cfg, "train", leaves, G22, batch=4,
                                   seq=8, microbatches=2, batch_split=True)
    P_ = 2 + (cfg.remat != "none")
    assert got["collective-permute"] == 0
    assert got["all-gather"] == dryrun.fsdp_all_gather(
        leaves, G22, passes=P_, microbatches=2)
    assert got["reduce-scatter"] == dryrun.grad_reduce_scatter(
        leaves, G22, microbatches=2)
    a = 4 if cfg.dtype == "float32" else 2
    assert got["all-reduce"] == dryrun.grad_all_reduce(
        leaves, G22, batch_split=True) + dryrun.tp_all_reduce(
        leaves, G22, passes=P_, microbatches=2, tokens=16, enc_tokens=0,
        act_bytes=a)
    assert got["all-to-all"] == dryrun.ep_all_to_all(
        leaves, G22, cfg, passes=P_, microbatches=2, tokens=16,
        act_bytes=a) > 0


# ------------------------------------------------------- the paper cell
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("variant", ["planewave", "padded"])
def test_paper_cell_plan_equals_the_reference(variant, grid):
    from repro.configs.fftb_paper import CONFIG as PC
    from repro.core import DistTensor, Domain, FftPlan
    g = _abstract(grid)
    rec = dryrun.lower_paper_workload(g, variant=variant, verbose=False)
    rg = RefProcGrid.create_abstract(*GRIDS[grid])
    fft_axes = tuple(i for i, a in enumerate(g.axes) if a == "model")
    batch_axes = tuple(i for i, a in enumerate(g.axes) if a != "model")
    if variant == "planewave":
        inv, _ = ref_make_planewave_pair(
            rg, PC.n, RefSphereDomain.from_diameter(PC.diameter), PC.nb,
            batch_axes=batch_axes, fft_axes=fft_axes)
        plan = inv.plan
    else:
        n, nb = PC.n, PC.nb
        bdom, cube = Domain((0,), (nb - 1,)), Domain((0,) * 3, (n - 1,) * 3)
        bs = "{%s}" % ",".join(map(str, batch_axes))
        fs = "{%s}" % ",".join(map(str, fft_axes))
        plan = FftPlan(DistTensor.create((bdom, cube), f"b{bs} x{fs} y z",
                                         rg),
                       DistTensor.create((bdom, cube), f"B{bs} X Y Z{fs}",
                                         rg),
                       [("x", "X"), ("y", "Y"), ("z", "Z")], inverse=True)
    assert rec["model_comm_bytes"] == plan.comm_stats()
    assert rec["plan"] == plan.describe()
    # FLOPs: the plan's global count spread over the devices
    assert rec["flops"] * g.nprocs == plan.flop_count()
    assert rec["collective_bytes"]["all-to-all"] * (15 / 16) == \
        sum(s["bytes_per_device"] for s in plan.comm_stats())


# ------------------------------------------------------------- the CLI
def test_main_writes_then_skips_a_cached_record(tmp_path, monkeypatch,
                                                capsys):
    out = tmp_path / "dryrun_torch.json"
    monkeypatch.setattr(dryrun, "RESULTS", str(out))
    argv = ["--arch", "tinyllama-1.1b", "--shape", "decode_32k"]
    assert dryrun.main(argv) == 0
    rec = json.loads(out.read_text())["tinyllama-1.1b|decode_32k|single"]
    assert rec["mesh"] == "16x16" and rec["flops"] > 0
    assert rec["collective_model"] == "reference specs"
    assert rec["peak_bytes_per_device"] == sum(rec["mem"].values())
    capsys.readouterr()
    assert dryrun.main(argv) == 0
    assert "cached tinyllama-1.1b|decode_32k|single" in capsys.readouterr().out


def test_long_500k_on_a_dense_arch_is_skipped_with_the_reference_reason(
        tmp_path, monkeypatch):
    out = tmp_path / "dryrun_torch.json"
    monkeypatch.setattr(dryrun, "RESULTS", str(out))
    assert dryrun.main(["--arch", "qwen3-32b", "--shape", "long_500k",
                        "--mesh", "both"]) == 0
    db = json.loads(out.read_text())
    _, why = ref_applicable(ref_config("qwen3-32b"), SHAPES["long_500k"])
    for g in ("single", "multi"):
        assert db[f"qwen3-32b|long_500k|{g}"]["skipped"] == why
