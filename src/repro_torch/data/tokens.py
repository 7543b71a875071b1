"""Token data sources: deterministic synthetic + memmap'd binary corpora.

The port's copy of ``repro.data.tokens``: numpy batches, bitwise equal to
the reference's.

Both sources are *sharded* and *stateless-resumable*: a (step, shard)
pair fully determines the batch, so checkpoint-restart and elastic
rescaling (different shard count after a failure) never replay or skip
data nondeterministically.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

__all__ = ["SyntheticTokens", "MemmapTokens", "Batch"]


@dataclasses.dataclass
class Batch:
    tokens: np.ndarray     # (B, S) int32
    labels: np.ndarray     # (B, S) int32 (next-token)
    mask: np.ndarray       # (B, S) float32


class SyntheticTokens:
    """Deterministic pseudo-corpus: token t of document d is a hash mix —
    structured enough that loss decreases (bigram-ish patterns), cheap to
    generate at any (step, shard) without state."""

    def __init__(self, vocab_size: int, seq_len: int, *, seed: int = 0) -> None:
        self.vocab = vocab_size
        self.seq = seq_len
        self.seed = seed

    def batch(self, step: int, shard: int, num_shards: int, per_shard: int) -> Batch:
        idx = step * num_shards + shard
        rng = np.random.default_rng((self.seed << 32) ^ idx)
        base = rng.integers(0, self.vocab, (per_shard, 1), dtype=np.int64)
        drift = rng.integers(1, 7, (per_shard, self.seq + 1), dtype=np.int64).cumsum(1)
        toks = ((base + drift * 2654435761) % self.vocab).astype(np.int32)
        return Batch(
            tokens=toks[:, :-1],
            labels=toks[:, 1:],
            mask=np.ones((per_shard, self.seq), np.float32),
        )


class MemmapTokens:
    """Flat binary corpus (np.int32 tokens) sampled in fixed windows.

    Sampling is strided-deterministic: window w of (step, shard) starts at
    ``hash(step, shard, w) % (n_tokens − seq − 1)`` — stateless, resumable,
    shard-disjoint in expectation.
    """

    def __init__(self, path: str | Path, seq_len: int, *, dtype=np.int32) -> None:
        self.path = Path(path)
        self.seq = seq_len
        self.data = np.memmap(self.path, dtype=dtype, mode="r")
        if len(self.data) < seq_len + 2:
            raise ValueError(f"corpus too small: {len(self.data)} tokens")

    @staticmethod
    def write_corpus(path: str | Path, tokens: np.ndarray) -> None:
        np.asarray(tokens, np.int32).tofile(path)

    def batch(self, step: int, shard: int, num_shards: int, per_shard: int) -> Batch:
        n = len(self.data)
        span = n - self.seq - 1
        toks = np.empty((per_shard, self.seq + 1), np.int32)
        for w in range(per_shard):
            h = np.uint64((step * 2654435761 + shard * 40503 + w * 69069 + 12345) % (2**63))
            h ^= h >> np.uint64(13)
            h *= np.uint64(0x9E3779B97F4A7C15)
            h ^= h >> np.uint64(7)
            start = int(h % np.uint64(span))
            toks[w] = self.data[start : start + self.seq + 1]
        return Batch(
            tokens=toks[:, :-1],
            labels=toks[:, 1:],
            mask=np.ones((per_shard, self.seq), np.float32),
        )
