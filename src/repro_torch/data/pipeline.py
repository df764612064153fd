"""Deterministic, shardable, checkpointable token pipeline: a copy of
``repro/data/pipeline.py`` (numpy only, so its batches are the
reference's bit for bit; the training step moves them to the device).

Two sources:
  * ``synthetic`` — a structured pseudo-language (Zipfian unigrams filtered
    through an order-2 Markov mixing so a model can actually learn
    something in a few hundred steps) generated counter-based from
    (seed, step, shard): no state to snapshot except the step counter.
  * ``corpus``   — a flat token memmap (np.uint16/uint32 file) sliced
    cyclically; each data shard reads a disjoint stride.

Determinism/fault-tolerance contract: ``batch_at(step)`` is a pure
function, so restarts resume bitwise-identically from the checkpointed
step, and *elastic* restarts (different shard count) keep global batch
content identical because sharding happens by slicing a step's global
batch, not by per-shard RNG streams.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"       # synthetic | corpus
    corpus_path: str | None = None
    zipf_a: float = 1.2             # synthetic unigram skew
    markov_order: int = 2


@dataclass
class DataState:
    """Everything the checkpoint needs to resume the pipeline."""
    step: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DataState":
        return cls(**d)


class TokenStream:
    """Counter-based batch source; see module docstring."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.state = DataState()
        if cfg.source == "corpus":
            if not cfg.corpus_path:
                raise ValueError("corpus source needs corpus_path")
            self._corpus = np.load(cfg.corpus_path, mmap_mode="r")
            if self._corpus.ndim != 1:
                raise ValueError("corpus must be a flat token array")
        else:
            self._corpus = None
            rng = np.random.default_rng(cfg.seed ^ 0x5EED)
            # fixed random Markov transition used by every batch
            v = cfg.vocab_size
            self._trans = rng.integers(0, v, size=(min(v, 4096), 8),
                                       dtype=np.int64)

    # -- pure batch construction -----------------------------------------
    def batch_at(self, step: int, *, shard: int = 0, n_shards: int = 1
                 ) -> dict:
        """Global batch for ``step`` sliced to ``shard`` of ``n_shards``.

        Returns {"tokens": (b, S) i32, "labels": (b, S) i32} with
        b = global_batch / n_shards; labels are next-token shifted with the
        final position masked (-1).
        """
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError(f"global_batch {cfg.global_batch} not divisible "
                             f"by n_shards {n_shards}")
        b = cfg.global_batch // n_shards
        lo, hi = shard * b, (shard + 1) * b
        if cfg.source == "corpus":
            toks = self._corpus_batch(step)[lo:hi]
        else:
            toks = self._synth_batch(step)[lo:hi]
        labels = np.concatenate(
            [toks[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def next_batch(self, *, shard: int = 0, n_shards: int = 1) -> dict:
        out = self.batch_at(self.state.step, shard=shard, n_shards=n_shards)
        self.state.step += 1
        return out

    # -- sources -----------------------------------------------------------
    def _synth_batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        # Zipfian unigrams
        u = rng.zipf(cfg.zipf_a, size=(B, S)).astype(np.int64)
        toks = (u - 1) % V
        # Markov smoothing: with p=0.6 the next token is a deterministic
        # function of the previous token (order-1 -> learnable by ANY
        # sequence model) xor'd once with the token two back (a little
        # longer-range signal for the recurrent archs).
        follow = rng.random((B, S)) < 0.6
        t = self._trans
        nrows = t.shape[0]
        for j in range(max(cfg.markov_order, 1), S):
            det = t[toks[:, j - 1] % nrows, 0] % V
            det2 = t[toks[:, j - 2] % nrows, 1] % V
            pick2 = (toks[:, j - 1] % 7) == 0
            toks[:, j] = np.where(follow[:, j],
                                  np.where(pick2, det2, det), toks[:, j])
        return toks.astype(np.int32)

    def _corpus_batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        B, S = cfg.global_batch, cfg.seq_len
        n = self._corpus.shape[0]
        span = B * S
        start = (step * span) % max(n - span, 1)
        flat = np.asarray(self._corpus[start:start + span])
        if flat.shape[0] < span:                       # wrap around
            flat = np.concatenate([flat, self._corpus[:span - flat.shape[0]]])
        return flat.reshape(B, S).astype(np.int32)


def make_stream(cfg: DataConfig) -> TokenStream:
    return TokenStream(cfg)
