"""Deterministic, checkpointable data pipeline.

Every batch is a pure function of (seed, step) — no iterator state — so:
  * resume after restart is exact (the cursor is just the step number,
    stored in the checkpoint),
  * straggler re-execution is deterministic (a recomputed step consumes
    identical data),
  * elastic re-sharding needs no data repartitioning (each new mesh slices
    the same global batch).

Two sources: ``SyntheticLMSource`` (structured pseudo-text: token n-gram
chains, so the loss has learnable signal) and ``ByteFileSource`` (byte-level
tokens from a real file).
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLMSource:
    """Markov-chain token stream: next token depends on the previous one.

    A model that learns the chain drops well below the uniform-vocab
    entropy, which the trainer tests assert.
    """

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4  # successors per token

    def _successors(self, tokens: np.ndarray, rng: np.random.Generator):
        # successor(tok, j) = deterministic hash; pick j randomly per step
        j = rng.integers(0, self.branching, size=tokens.shape)
        t64 = tokens.astype(np.int64)
        return ((t64 * 2654435761 + j * 40503 + 17) % self.vocab).astype(np.int32)

    def batch_at(self, step: int) -> dict:
        rng = np.random.Generator(np.random.Philox(key=self.seed, counter=[0, 0, 0, step]))
        toks = np.empty((self.global_batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=self.global_batch)
        for t in range(self.seq_len):
            toks[:, t + 1] = self._successors(toks[:, t], rng)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@dataclasses.dataclass(frozen=True)
class ByteFileSource:
    """Byte-level LM batches from a file, deterministically strided."""

    path: str
    seq_len: int
    global_batch: int
    seed: int = 0

    def __post_init__(self):
        data = np.frombuffer(pathlib.Path(self.path).read_bytes(), np.uint8)
        if data.size < (self.seq_len + 1) * 2:
            raise ValueError(f"{self.path}: too small ({data.size} bytes)")
        object.__setattr__(self, "_data", data)

    @property
    def vocab(self) -> int:
        return 256

    def batch_at(self, step: int) -> dict:
        rng = np.random.Generator(np.random.Philox(key=self.seed, counter=[0, 0, 0, step]))
        data = self._data
        starts = rng.integers(0, data.size - self.seq_len - 1, size=self.global_batch)
        idx = starts[:, None] + np.arange(self.seq_len + 1)[None]
        toks = data[idx].astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def make_source(kind: str, **kw):
    if kind == "synthetic":
        return SyntheticLMSource(**kw)
    if kind == "bytes":
        return ByteFileSource(**kw)
    raise ValueError(f"unknown data source {kind!r}")
