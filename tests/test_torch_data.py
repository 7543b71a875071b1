"""The port's data pipeline against the JAX package's, on the CPU.

``SyntheticTokens`` and ``MemmapTokens`` batches are bitwise equal to
the reference's over several (step, shard, num_shards, per_shard), and
the ``Prefetcher`` keeps order, delivers a producer's error in order and
closes cleanly.
"""

import threading

import numpy as np
import pytest

from repro.data import MemmapTokens as JaxMemmapTokens
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro_torch.data import MemmapTokens, Prefetcher, SyntheticTokens

CASES = [(0, 0, 1, 8), (3, 1, 4, 2), (17, 3, 4, 5), (1000, 0, 2, 1)]


def assert_batches_equal(got, want):
    for field in ("tokens", "labels", "mask"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field


@pytest.mark.parametrize("step,shard,num_shards,per_shard", CASES)
@pytest.mark.parametrize("vocab,seq,seed", [(32000, 64, 0), (256, 17, 7)])
def test_synthetic_tokens_bitwise(vocab, seq, seed, step, shard, num_shards, per_shard):
    got = SyntheticTokens(vocab, seq, seed=seed).batch(step, shard, num_shards, per_shard)
    want = JaxSyntheticTokens(vocab, seq, seed=seed).batch(step, shard, num_shards, per_shard)
    assert_batches_equal(got, want)
    assert got.tokens.shape == (per_shard, seq)
    assert np.array_equal(got.tokens[:, 1:], got.labels[:, :-1])


@pytest.mark.parametrize("step,shard,num_shards,per_shard", CASES)
def test_memmap_tokens_bitwise(tmp_path, step, shard, num_shards, per_shard):
    corpus = np.random.default_rng(3).integers(0, 50000, 4099).astype(np.int32)
    path = tmp_path / "corpus.bin"
    MemmapTokens.write_corpus(path, corpus)
    got = MemmapTokens(path, 33).batch(step, shard, num_shards, per_shard)
    want = JaxMemmapTokens(path, 33).batch(step, shard, num_shards, per_shard)
    assert_batches_equal(got, want)


def test_memmap_refuses_a_short_corpus(tmp_path):
    path = tmp_path / "tiny.bin"
    MemmapTokens.write_corpus(path, np.arange(10))
    with pytest.raises(ValueError, match="corpus too small"):
        MemmapTokens(path, 16)


def test_prefetcher_keeps_order():
    pf = Prefetcher(lambda step: step * 10, depth=2, start_step=5)
    try:
        got = [pf.get(timeout=10) for _ in range(6)]
    finally:
        pf.close()
    assert got == [(s, s * 10) for s in range(5, 11)]


def test_prefetcher_delivers_an_error_in_order():
    def make(step):
        if step == 3:
            raise RuntimeError("bad batch 3")
        return step

    pf = Prefetcher(make, depth=2)
    try:
        assert [pf.get(timeout=10) for _ in range(3)] == [(0, 0), (1, 1), (2, 2)]
        with pytest.raises(RuntimeError, match="bad batch 3"):
            pf.get(timeout=10)
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_closes_while_the_producer_is_parked():
    made = threading.Event()

    def make(step):
        made.set()
        return step

    pf = Prefetcher(make, depth=1)
    assert made.wait(10)
    pf.close()
    assert not pf._thread.is_alive()
