"""Deterministic synthetic LM data pipeline.

A copy of ``repro.data.pipeline``: structured pseudo-text (a Zipfian token
stream with short-range bigram structure) that models can learn, fully
seeded, so that the HadarE-against-Hadar quality comparison sees the same
data under every scheduler.  NumPy only: the batches are bitwise those of
the JAX package, the stub ``patches``/``frames`` of vlm and encdec
included, because the ``RandomState`` draws come in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    n_batches: int = 0          # 0 = infinite
    vlm_patches: int = 0        # >0: attach stub patch embeddings
    enc_frames: int = 0         # >0: attach stub encoder frames
    d_model: int = 0


class SyntheticLM:
    """Zipf unigram + deterministic bigram successor chain."""

    def __init__(self, dc: DataConfig):
        self.dc = dc
        rng = np.random.RandomState(dc.seed)
        v = dc.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # each token has a preferred successor: learnable structure
        self.successor = rng.permutation(v)
        self.p_follow = 0.65

    def _sample_doc(self, rng: np.random.RandomState, length: int):
        v = self.dc.vocab_size
        out = np.empty(length, np.int32)
        out[0] = rng.choice(v, p=self.unigram)
        follow = rng.random_sample(length) < self.p_follow
        fresh = rng.choice(v, size=length, p=self.unigram)
        for i in range(1, length):
            out[i] = self.successor[out[i - 1]] if follow[i] else fresh[i]
        return out

    def batches(self, start: int = 0) -> Iterator[dict]:
        """NumPy batches ``tokens``/``labels`` (B, S) int32 (labels are
        the tokens shifted by one), and ``patches``/``frames`` (B, P, d)
        float32 where the config asks for them; batch i is drawn from its
        own seed, so ``start`` skips ahead without drawing."""
        dc = self.dc
        i = start
        while dc.n_batches == 0 or i < dc.n_batches:
            rng = np.random.RandomState((dc.seed * 1_000_003 + i) % 2**31)
            toks = np.stack([self._sample_doc(rng, dc.seq_len + 1)
                             for _ in range(dc.batch_size)])
            batch = {"tokens": toks[:, :-1].astype(np.int32),
                     "labels": toks[:, 1:].astype(np.int32)}
            if dc.vlm_patches:
                batch["patches"] = rng.standard_normal(
                    (dc.batch_size, dc.vlm_patches, dc.d_model)
                ).astype(np.float32)
            if dc.enc_frames:
                batch["frames"] = rng.standard_normal(
                    (dc.batch_size, dc.enc_frames, dc.d_model)
                ).astype(np.float32)
            yield batch
            i += 1


def data_config(cfg, batch_size: int, seq_len: int,
                seed: int = 0) -> DataConfig:
    """The ``DataConfig`` of batches shaped for ``cfg``: the vlm's patches
    and the encdec's frames, ``cfg.enc_seq`` of them."""
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      batch_size=batch_size, seed=seed,
                      vlm_patches=cfg.enc_seq if cfg.family == "vlm" else 0,
                      enc_frames=cfg.enc_seq if cfg.family == "encdec" else 0,
                      d_model=cfg.d_model)


def batch_for(cfg, batch_size: int, seq_len: int, seed: int = 0) -> dict:
    """One deterministic batch shaped for ``cfg`` (tests, examples)."""
    return next(SyntheticLM(data_config(cfg, batch_size, seq_len,
                                        seed)).batches())
