"""Deterministic synthetic token pipeline for LM training.

``batch_at(cfg, shape, step)`` is a pure function of (seed, step): a
restarted job replays the exact stream with no shuffle-buffer state to
checkpoint, the data-side half of fault tolerance.

The stream is the reference's: a seeded Markov chain over the vocabulary
whose successor tables (``_chain``) are the reference's arrays, with a
Zipfian choice over each state's successor slots, and the vlm patches and
audio frames beside the tokens. The reference samples with jax's threefry
keys, which the port does not reproduce; the port's draws come from a
numpy generator seeded with (seed, step), so its stream is its own
(ROADMAP C).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.params import torch_dtype


@functools.lru_cache(maxsize=8)
def _chain(vocab: int, seed: int, branch: int = 32):
    """Sparse transition structure: each state -> ``branch`` successors, and
    the Zipfian probabilities of the slots (read-only arrays)."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, branch), dtype=np.int32)
    p = 1.0 / np.arange(1, branch + 1)
    p /= p.sum()
    p = p.astype(np.float32)
    succ.flags.writeable = False
    p.flags.writeable = False
    return succ, p


def _markov(succ, p, rng: np.random.Generator, B: int, S: int) -> np.ndarray:
    """(B, S) tokens: a random start state per row, then S - 1 transitions
    through a Zipf-chosen successor slot."""
    state = rng.integers(0, succ.shape[0], B, dtype=np.int32)
    slots = rng.choice(succ.shape[1], size=(S, B), p=p.astype(np.float64))
    toks = np.empty((S, B), np.int32)
    for t in range(S):
        toks[t] = state
        state = succ[state, slots[t]]
    return toks.T


def _extra(rng: np.random.Generator, shape: tuple, cfg: ModelConfig, device):
    """Stub frontend embeddings: normal * 0.02 in the compute dtype."""
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    dt = torch_dtype(cfg.dtype)
    return x.to(device=device, dtype=dt) * torch.tensor(0.02, dtype=dt, device=device)


def batch_at(cfg: ModelConfig, shape: ShapeConfig, step: int, *,
             seed: int = 0, batch_override: int | None = None, device=None) -> dict:
    """The training batch for ``step`` ({tokens, labels [, frames,
    patches]}), deterministically, on ``device`` (None is cuda)."""
    from repro_torch.core.engines import resolve_device
    dev = resolve_device(device)
    B = batch_override or shape.global_batch
    S = shape.seq_len
    succ, p = _chain(cfg.vocab_size, seed)
    rng = np.random.default_rng([seed, step])
    out = {}
    if cfg.family == "vlm":
        S -= cfg.n_patches
    toks = torch.from_numpy(_markov(succ, p, rng, B, S + 1)).to(dev)
    if cfg.family == "vlm":
        out["patches"] = _extra(rng, (B, cfg.n_patches, cfg.d_model), cfg, dev)
    elif cfg.family == "audio":
        out["frames"] = _extra(rng, (B, cfg.enc_seq, cfg.d_model), cfg, dev)
    out["tokens"] = toks[:, :-1]
    out["labels"] = toks[:, 1:]
    return out
