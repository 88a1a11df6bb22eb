"""Deterministic sharded token batches (port of ``repro.data.pipeline``).

Every host draws only its shard of the global batch, from a CPU
``torch.Generator`` seeded by a hash of (seed, step, shard_id): the step
index is the only state, so after a restore at step s, ``batch_at(s)``
is bit-identical however many hosts survived. The draws differ from the
reference's ``jax.random`` stream; a test hands the reference's draws
in through ``draws=``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import torch

_MASK = (1 << 64) - 1


def _mix(*words: int) -> int:
    """A 63-bit seed from the words (splitmix64 over each in turn)."""
    z = 0
    for w in words:
        z = (z + (w & _MASK) + 0x9E3779B97F4A7C15) & _MASK
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        z ^= z >> 31
    return z >> 1


def generator_at(*words: int) -> torch.Generator:
    """A CPU generator seeded from ``words`` (e.g. seed, step, shard)."""
    return torch.Generator().manual_seed(_mix(*words))


@dataclasses.dataclass
class ShardedBatcher:
    """Synthetic token stream sharded over the data axis. ``draws``:
    optional ``draws(step, shard_id) -> tokens`` (local_batch, seq_len)
    ints, in place of the generator's (the tests pass the reference's)."""
    global_batch: int
    seq_len: int
    vocab: int
    num_shards: int = 1
    shard_id: int = 0
    seed: int = 0
    draws: Callable | None = None

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.num_shards:
            raise ValueError(f"global batch {self.global_batch} is not a "
                             f"multiple of {self.num_shards} shards")
        return self.global_batch // self.num_shards

    def batch_at(self, step: int) -> dict:
        """The batch of ``step`` (replay-exact): int32 ``tokens`` (local
        batch, seq_len) on the CPU and ``labels``, the tokens rolled one
        position left."""
        if self.draws is not None:
            tokens = torch.tensor(self.draws(step, self.shard_id),
                                  dtype=torch.int32)
        else:
            tokens = torch.randint(
                0, self.vocab, (self.local_batch, self.seq_len),
                generator=generator_at(self.seed, step, self.shard_id),
                dtype=torch.int32)
        return {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def token_batches(global_batch: int, seq_len: int, vocab: int, steps: int,
                  seed: int = 0, draws=None):
    """The first ``steps`` batches of one unsharded stream."""
    b = ShardedBatcher(global_batch, seq_len, vocab, seed=seed, draws=draws)
    for s in range(steps):
        yield b.batch_at(s)
