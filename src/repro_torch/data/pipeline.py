"""Deterministic, sharded synthetic token pipeline (port of
`repro.data.pipeline`, numpy only and unchanged, so that a batch is the
reference's batch byte for byte for any seed, step and host).

Design goals (matching what a production loader must guarantee):
  * **Determinism**: batch `i` is a pure function of (seed, i) — restarting
    from a checkpoint at step i reproduces the identical stream, which the
    EC-restore integration test relies on.
  * **Host sharding**: each host materialises only its slice of the global
    batch (`host_id`/`num_hosts`), the way multi-pod input pipelines slice
    tfds/grain streams.
  * **Stateless seeking**: no iterator state to checkpoint — the step index
    *is* the state (saved alongside the train state).

Tokens are drawn from a Zipf-like distribution so the loss curve is
non-trivial (uniform tokens give a constant-entropy floor immediately),
plus a learnable Markov structure so a model can actually improve.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # Zipf exponent for the unigram prior
    markov_order: int = 1        # next-token structure learnable by the model


class SyntheticTokenDataset:
    """Deterministic synthetic corpus with Zipf unigrams + Markov bigrams."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Zipf prior over the vocab (clipped for tiny vocabs).
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._prior = ranks ** (-cfg.zipf_a)
        self._prior /= self._prior.sum()
        # A sparse deterministic "grammar": each token has a preferred
        # successor; with prob 0.5 the stream follows it (learnable signal).
        self._successor = rng.permutation(v)

    def batch(self, step: int, *, host_id: int = 0, num_hosts: int = 1):
        """Returns (tokens, labels): (B_host, S) int32 each.

        labels = next token (shift-by-one of an S+1 stream).
        """
        cfg = self.cfg
        assert cfg.global_batch % num_hosts == 0
        b_host = cfg.global_batch // num_hosts
        # Derive the per-(step, host) stream from a counter-based RNG so any
        # batch is addressable in O(1) — no sequential iterator state.
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=cfg.seed,
                                   spawn_key=(step, host_id)))
        s1 = cfg.seq_len + 1
        draws = rng.choice(cfg.vocab_size, size=(b_host, s1), p=self._prior)
        follow = rng.random((b_host, s1)) < 0.5
        stream = draws.copy()
        for t in range(1, s1):
            stream[:, t] = np.where(follow[:, t],
                                    self._successor[stream[:, t - 1]],
                                    draws[:, t])
        tokens = stream[:, :-1].astype(np.int32)
        labels = stream[:, 1:].astype(np.int32)
        return tokens, labels


def make_train_iterator(cfg: DataConfig, *, start_step: int = 0,
                        host_id: int = 0, num_hosts: int = 1):
    """Infinite (step, tokens, labels) iterator, seekable by construction."""
    ds = SyntheticTokenDataset(cfg)
    step = start_step
    while True:
        tokens, labels = ds.batch(step, host_id=host_id, num_hosts=num_hosts)
        yield step, tokens, labels
        step += 1
