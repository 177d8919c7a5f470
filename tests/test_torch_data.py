"""repro_torch.data.pipeline against the reference ``repro.data.pipeline``.

Every batch is a pure function of (seed, step, shard) in both packages,
so the port's tokens and labels must equal the reference's bit for bit
(integers, no tolerance): across seeds, steps, shard counts and the
memmap source.  Then the reference's own pipeline tests
(``tests/test_data.py``), mirrored on the port.
"""
import numpy as np
import pytest

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import Pipeline as RefPipeline
from repro_torch.data.pipeline import DataConfig, Pipeline


def _both(**kw):
    return DataConfig(**kw), RefDataConfig(**kw)


def _equal(got, want):
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_batches_equal_the_reference(seed, n_shards):
    cfg, rcfg = _both(vocab=32000, seq=24, global_batch=8, seed=seed)
    for shard in range(n_shards):
        p, r = Pipeline(cfg, shard, n_shards), RefPipeline(rcfg, shard,
                                                           n_shards)
        for step in (0, 1, 7, 1000, 2**31):
            _equal(p.batch_at(step), r.batch_at(step))
        _equal(p.reassign((shard + 1) % n_shards, 3),
               r.reassign((shard + 1) % n_shards, 3))


def test_memmap_batches_equal_the_reference(tmp_path):
    data = (np.arange(5000, dtype=np.int64) * 7919 % 503).astype(np.int32)
    f = tmp_path / "tokens.bin"
    data.tofile(f)
    cfg, rcfg = _both(vocab=503, seq=16, global_batch=4, seed=3,
                      source="memmap", path=str(f))
    for shard, n in ((0, 1), (1, 2)):
        for step in (0, 5, 99):
            _equal(Pipeline(cfg, shard, n).batch_at(step),
                   RefPipeline(rcfg, shard, n).batch_at(step))


# ------------------------------------------- the reference's tests, mirrored
def test_labels_shift():
    p = Pipeline(DataConfig(vocab=50, seq=8, global_batch=2))
    b = p.batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_steps_differ():
    p = Pipeline(DataConfig(vocab=50, seq=8, global_batch=2))
    assert not np.array_equal(p.batch_at(0)["tokens"],
                              p.batch_at(1)["tokens"])


def test_seeds_differ():
    a = Pipeline(DataConfig(vocab=50, seq=8, global_batch=2, seed=0))
    b = Pipeline(DataConfig(vocab=50, seq=8, global_batch=2, seed=1))
    assert not np.array_equal(a.batch_at(0)["tokens"],
                              b.batch_at(0)["tokens"])


def test_restart_mid_epoch_identical():
    cfg = DataConfig(vocab=1000, seq=16, global_batch=4)
    p1 = Pipeline(cfg)
    seq = [p1.batch_at(s)["tokens"] for s in range(5)]
    p2 = Pipeline(cfg)          # "restarted" process
    np.testing.assert_array_equal(p2.batch_at(3)["tokens"], seq[3])


def test_shards_partition_batch():
    cfg = DataConfig(vocab=1000, seq=8, global_batch=8)
    full = Pipeline(cfg).batch_at(7)["tokens"]
    parts = [Pipeline(cfg, s, 4).batch_at(7)["tokens"] for s in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), full)


def test_backup_worker_reassignment():
    cfg = DataConfig(vocab=1000, seq=8, global_batch=8)
    healthy = Pipeline(cfg, 0, 4)
    dead_batch = Pipeline(cfg, 2, 4).batch_at(11)
    recomputed = healthy.reassign(2, 11)
    np.testing.assert_array_equal(recomputed["tokens"],
                                  dead_batch["tokens"])


def test_memmap_source(tmp_path):
    data = np.arange(10000, dtype=np.int32) % 97
    f = tmp_path / "tokens.bin"
    data.tofile(f)
    cfg = DataConfig(vocab=97, seq=16, global_batch=4, source="memmap",
                     path=str(f))
    p = Pipeline(cfg)
    b = p.batch_at(0)
    assert b["tokens"].shape == (4, 16)
    assert (b["tokens"] < 97).all()
    b2 = Pipeline(cfg).batch_at(0)
    np.testing.assert_array_equal(b["tokens"], b2["tokens"])


def test_indivisible_shards_rejected():
    with pytest.raises(ValueError):
        Pipeline(DataConfig(vocab=10, seq=4, global_batch=4), 0, 3)


def test_port_imports_neither_jax_nor_the_reference():
    import repro_torch.data.pipeline as mod
    src = open(mod.__file__).read()
    assert "import jax" not in src and "from repro." not in src
