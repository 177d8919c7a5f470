"""repro_torch.configs.base against the reference ``repro.configs.base``.

Every architecture of ``ARCH_IDS``: the port's config equals the
reference's field by field, and so do its ``reduced()`` config and the
analytic parameter counts; ``SHAPES`` and the ``applicable`` rule are the
same.  Pure data: compared exactly.
"""
import dataclasses

import pytest

import repro.configs.base as R
import repro_torch.configs.base as T


@pytest.mark.parametrize("arch", R.ARCH_IDS)
def test_config_matches_reference(arch):
    ref, got = R.get_config(arch), T.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(ref.reduced())
    for cfg, rcfg in ((got, ref), (got.reduced(), ref.reduced())):
        assert cfg.param_count() == rcfg.param_count()
        assert cfg.active_param_count() == rcfg.active_param_count()
        assert (cfg.d_inner, cfg.ssm_nheads) == \
            (rcfg.d_inner, rcfg.ssm_nheads)


def test_registry_and_shapes_match_reference():
    assert T.ARCH_IDS == R.ARCH_IDS
    assert set(T.all_configs()) >= set(T.ARCH_IDS)
    assert {k: dataclasses.asdict(v) for k, v in T.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in R.SHAPES.items()}


@pytest.mark.parametrize("shape", list(R.SHAPES))
def test_applicable_matches_reference(shape):
    for arch in R.ARCH_IDS:
        assert T.applicable(T.get_config(arch), T.SHAPES[shape]) == \
            R.applicable(R.get_config(arch), R.SHAPES[shape])


def test_get_config_loads_the_port_module():
    """``get_config`` imports ``repro_torch.configs.<id>`` (never the
    reference's), and an unknown id raises."""
    import sys
    T.get_config("whisper-small")
    assert "repro_torch.configs.whisper_small" in sys.modules
    with pytest.raises(ModuleNotFoundError):
        T.get_config("no-such-model")
