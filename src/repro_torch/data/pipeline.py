"""Deterministic, resumable, sharded synthetic data pipeline: the port's
own copy of ``repro/data/pipeline.py`` (numpy only, the same seeds, so
the same tokens bit for bit).

Serves the role of the paper's HDFS data-chunk layer (Sec. III-B): the
token stream is split into *chunks*; each data-parallel worker reads the
chunks assigned to it for the current slot.  The stream is a seeded
Markov-ish token process with induction structure so language models
actually reduce loss on it (used by examples/ and the e2e tests).

State is an explicit (epoch, step) cursor — checkpointable, and
re-shardable when the worker count changes (elastic re-mesh): chunk
assignment is a pure function of (step, n_workers).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_chunks: int = 1024          # dataset chunks (paper's N_i)


class SyntheticStream:
    """Zipf unigrams + copy/induction patterns => learnable structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        probs = 1.0 / np.arange(1, cfg.vocab_size + 1) ** 1.1
        self._probs = probs / probs.sum()

    def chunk(self, chunk_id: int) -> np.ndarray:
        """One deterministic chunk of tokens: (seq_len + 1,) per sample row."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1_000_003 + chunk_id)
        toks = rng.choice(cfg.vocab_size, size=cfg.seq_len + 1, p=self._probs)
        # induction: repeat a motif so in-context copying is learnable
        mlen = int(rng.integers(4, 12))
        motif = rng.choice(cfg.vocab_size, size=mlen, p=self._probs)
        pos = 0
        while pos + mlen < cfg.seq_len:
            toks[pos:pos + mlen] = motif
            pos += int(rng.integers(mlen, 4 * mlen))
        return toks.astype(np.int32)


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def to_dict(self) -> Dict:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d: Dict) -> "PipelineState":
        return cls(step=int(d["step"]))


class DataPipeline:
    """Batch iterator with explicit cursor; assignment is worker-count
    agnostic so elastic rescale replays no data and skips none."""

    def __init__(self, cfg: DataConfig, state: Optional[PipelineState] = None):
        self.cfg = cfg
        self.stream = SyntheticStream(cfg)
        self.state = state or PipelineState()

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = []
        base = self.state.step * cfg.global_batch
        for i in range(cfg.global_batch):
            chunk_id = (base + i) % cfg.n_chunks
            rows.append(self.stream.chunk(chunk_id))
        arr = np.stack(rows)                              # (B, S+1)
        self.state.step += 1
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:].copy()}

    # -- elastic view: per-worker shard of the global batch ----------------
    def worker_slice(self, batch: Dict[str, np.ndarray], worker: int,
                     n_workers: int) -> Dict[str, np.ndarray]:
        assert self.cfg.global_batch % n_workers == 0
        per = self.cfg.global_batch // n_workers
        sl = slice(worker * per, (worker + 1) * per)
        return {k: v[sl] for k, v in batch.items()}
