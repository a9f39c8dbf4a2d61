"""Deterministic synthetic LM corpus with learnable structure. Port of
`repro/data/synthetic.py`.

A fixed-seed bigram transition table over the vocab (random successor
sets with peaked probabilities) generates token streams a small LM can
learn: held-out perplexity drops well below the unigram entropy, without
an external dataset.

The tables (`_tables`, numpy `default_rng(seed)`) and so `bigram_entropy`
are the reference's exactly. Sampling is stateless, as the reference's:
document i's tokens are a pure function of (seed, i), so any worker can
make any batch, which the restart-safe loader relies on. The reference
draws a document's start token and uniforms with JAX's threefry
(`fold_in(PRNGKey(seed), i)`), which the port does not import; the port
draws them from numpy's counter-based Philox keyed by (seed, i). So the
port's token stream differs from the reference's, while its tables,
statistics and statelessness are the same; tests that compare training
trajectories feed the reference's batches to the port.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusCfg:
    vocab: int = 512
    seed: int = 1234
    branch: int = 4          # plausible next-tokens per token
    temperature: float = 0.35


@functools.lru_cache(maxsize=8)
def _tables(cfg: CorpusCfg):
    """(successors (vocab, branch) int32, cumulative probabilities
    (vocab, branch) float32); made once a config."""
    rng = np.random.default_rng(cfg.seed)
    succ = rng.integers(0, cfg.vocab, size=(cfg.vocab, cfg.branch))
    logit = rng.normal(size=(cfg.vocab, cfg.branch)) / cfg.temperature
    probs = np.exp(logit - logit.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    cum = np.cumsum(probs, axis=1)
    return succ.astype(np.int32), cum.astype(np.float32)


def _doc_draws(cfg: CorpusCfg, doc_id: int, seq_len: int):
    """Document `doc_id`'s start token and `seq_len` float32 uniforms,
    from Philox keyed by (seed, doc id)."""
    gen = np.random.Generator(np.random.Philox(
        key=np.array([cfg.seed, doc_id], dtype=np.uint64)))
    t0 = gen.integers(0, cfg.vocab)
    return t0, gen.random(seq_len, dtype=np.float32)


def sample_batch(cfg: CorpusCfg, doc_ids, seq_len: int,
                 batch: int) -> np.ndarray:
    """doc_ids: (batch,) document ids. Returns tokens (batch, seq_len)
    int64 in [0, vocab): from each document's start token, token t + 1
    is the successor of token t whose cumulative probability first
    reaches the document's uniform u_t (the reference's walk)."""
    succ, cum = _tables(cfg)
    ids = np.asarray(doc_ids, dtype=np.int64).reshape(batch)
    draws = [_doc_draws(cfg, int(d), seq_len) for d in ids]
    tok = np.array([t0 for t0, _ in draws], dtype=np.int64)
    us = np.stack([u for _, u in draws])                # (batch, seq_len)
    out = np.empty((batch, seq_len), dtype=np.int64)
    last = cfg.branch - 1
    for j in range(seq_len):
        idx = np.sum(us[:, j, None] > cum[tok], axis=1)
        tok = succ[tok, np.minimum(idx, last)].astype(np.int64)
        out[:, j] = tok
    return out


def bigram_entropy(cfg: CorpusCfg) -> float:
    """Per-token entropy of the generator (nats): the PPL floor."""
    _, cum = _tables(cfg)
    p = np.diff(np.concatenate([np.zeros((cum.shape[0], 1)), cum], axis=1),
                axis=1)
    h = -(p * np.log(np.maximum(p, 1e-12))).sum(1)
    return float(h.mean())
