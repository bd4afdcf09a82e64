"""Synthetic token streams for training/serving drivers and smoke tests.

Deterministic per (seed, step) so restarts resume mid-epoch without host
state (fault-tolerance: the data pipeline is a pure function of the step
counter — see repro_torch.runtime).  A copy of the JAX package's numpy
module, so that the port imports none of it."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenGenConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    n_frontend_tokens: int = 0   # audio/vlm memory stub
    d_model: int = 0


def batch_at(cfg: TokenGenConfig, step: int):
    """Pure function (cfg, step) -> batch dict (numpy, host-side)."""
    rng = np.random.default_rng((cfg.seed * 1_000_003 + step) & 0x7FFFFFFF)
    toks = rng.integers(0, cfg.vocab_size,
                        size=(cfg.batch, cfg.seq_len + 1)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.n_frontend_tokens:
        batch["memory"] = rng.normal(
            0, 1, size=(cfg.batch, cfg.n_frontend_tokens,
                        cfg.d_model)).astype(np.float32)
    return batch


def token_batches(cfg: TokenGenConfig, start_step: int = 0):
    """Infinite iterator of batches starting at `start_step` (resumable)."""
    step = start_step
    while True:
        yield step, batch_at(cfg, step)
        step += 1
