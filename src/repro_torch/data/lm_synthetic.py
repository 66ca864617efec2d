"""Deterministic synthetic LM token pipeline: zipfian unigrams + first-order
markov bigram structure (so the loss actually decreases), document packing
with EOS, host-sharded loading for multi-process pods."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

EOS = 1


def _markov_row_sampler(rng: np.random.RandomState, vocab: int):
    """Cheap structured bigram: next ~ (cur * a + b) mod zipf-bucket."""
    a = rng.randint(3, 97) | 1
    b = rng.randint(1, vocab)

    def next_token(cur: np.ndarray, noise: np.ndarray) -> np.ndarray:
        zipf = np.minimum(noise, vocab - 1)
        structured = (cur * a + b) % vocab
        pick = (noise % 4 == 0)
        return np.where(pick, zipf, structured)

    return next_token


def lm_token_stream(
    vocab_size: int,
    batch: int,
    seq_len: int,
    *,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {'tokens': [b_local, S], 'labels': [b_local, S]} forever.
    Deterministic in (seed, step, process_index); each process gets a
    disjoint batch shard."""
    assert batch % process_count == 0
    b_local = batch // process_count
    step = 0
    while True:
        rng = np.random.RandomState(
            (seed * 1_000_003 + step) % (2 ** 31 - 1))
        nxt = _markov_row_sampler(rng, vocab_size)
        # zipfian noise source
        noise = rng.zipf(1.3, size=(batch, seq_len + 1)).astype(np.int64)
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = noise[:, 0] % vocab_size
        for t in range(1, seq_len + 1):
            toks[:, t] = nxt(toks[:, t - 1].astype(np.int64),
                             noise[:, t]).astype(np.int32)
        # sprinkle document boundaries
        doc_mask = rng.rand(batch, seq_len + 1) < (1.0 / 512)
        toks = np.where(doc_mask, EOS, toks) % vocab_size
        lo = process_index * b_local
        sl = slice(lo, lo + b_local)
        yield {"tokens": toks[sl, :-1], "labels": toks[sl, 1:].copy()}
        step += 1
