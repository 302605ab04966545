"""SequenceVectors: the generic embedding trainer (skip-gram / CBOW with
negative sampling).

Counterpart of ``deeplearning4j_tpu/nlp/sequence_vectors.py`` (the
reference's ``SequenceVectors.java`` with its ``SkipGram`` / ``CBOW``
element learners), with the same semantics:

- training examples are made on the host in batches of exactly
  ``batch_size`` (the last one padded by repetition), from the numpy
  ``RandomState`` streams of the JAX package in its order: the tables
  from ``RandomState(seed)``, then a second ``RandomState(seed)`` for the
  subsampling draws, the dynamic-window draws and the negatives
  (``rng.choice(p=unigram table)``, drawn as each batch completes);
- each batch is cut into ``batch_size // S`` chunks, S the largest
  divisor of ``batch_size`` that is <= 64 (:func:`micro_chunk`), applied
  one after another, each seeing the tables the previous one left;
- the loss of a chunk is the SUM over its examples of
  ``-log σ(v·u+) - Σ log σ(-v·u-)``, a negative that hits the positive
  word skipped; an epoch's learning rate decays linearly.

The JAX step takes the gradient of that loss against the whole [V, D]
tables and applies ``w - lr·g``. Here the same update is computed in
closed form and added with ``index_add_`` to the rows the chunk touched,
in place (the trainer owns its tables): no dense [V, D] gradient a
chunk. Rows named more than once get the sum of their updates, as the
dense gradient sums them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .vocab import VocabCache, unigram_table


@dataclasses.dataclass
class SGNSConfig:
    layer_size: int = 100
    window: int = 5
    negative: int = 5
    learning_rate: float = 0.025
    min_learning_rate: float = 1e-4
    epochs: int = 1
    batch_size: int = 2048
    subsample: float = 0.0      # frequent-word downsampling threshold
                                # (0 = off, reference Word2Vec default)
    seed: int = 12345
    cbow: bool = False          # False = skip-gram


def micro_chunk(batch_size: int, micro: int = 64) -> int:
    """Largest divisor of batch_size that is <= micro: the chunk size must
    divide the (padded, exact) batch or remainder examples are dropped."""
    for s in range(min(micro, batch_size), 0, -1):
        if batch_size % s == 0:
            return s
    return 1


def ns_chunk(w_in, w_out, rows, rmask, denom, ids, wmask, labels, lr):
    """One negative-sampling SGD chunk, IN PLACE on ``w_in`` / ``w_out``;
    returns the chunk's summed loss (a 0-d tensor).

    The input vector of example b is ``w_in[rows[b]]`` (``rmask`` None,
    skip-gram) or the masked sum ``Σ_r w_in[rows[b, r]] · rmask[b, r]``
    over ``denom[b]`` (CBOW's context mean, FastText's word plus n-gram
    rows). ``ids`` [S, 1+K] are the output rows (the positive, then the
    negatives), ``labels`` [1+K] their 1 / 0 targets and ``wmask``
    [S, 1+K] 0 where a negative hits the positive. Every gradient is
    taken from the tables as the chunk found them, then applied."""
    if rmask is None:
        v = w_in[rows]                                    # [S, D]
    else:
        v = (w_in[rows] * rmask[..., None]).sum(dim=1) / denom
    u = w_out[ids]                                        # [S, 1+K, D]
    logits = torch.bmm(u, v[..., None])[..., 0]           # [S, 1+K]
    # -log σ(l) for the positive, -log σ(-l) for a negative
    loss = -(F.logsigmoid((2 * labels - 1) * logits) * wmask).sum()
    g = (torch.sigmoid(logits) - labels) * wmask          # dloss/dlogits
    dv = torch.bmm(g[:, None, :], u)[:, 0]                # [S, D]
    du = g[..., None] * v[:, None, :]                     # [S, 1+K, D]
    D = v.shape[-1]
    w_out.index_add_(0, ids.reshape(-1), du.reshape(-1, D), alpha=-lr)
    if rmask is None:
        w_in.index_add_(0, rows, dv, alpha=-lr)
    else:
        drows = (dv / denom)[:, None, :] * rmask[..., None]
        w_in.index_add_(0, rows.reshape(-1), drows.reshape(-1, D),
                        alpha=-lr)
    return loss


def _output_rows(targets, negatives):
    """(ids [B, 1+K], wmask [B, 1+K]): the positive then the negatives, a
    negative equal to the positive masked out."""
    ids = np.concatenate([targets[:, None], negatives], axis=1)
    wmask = np.concatenate([np.ones((len(targets), 1), np.float32),
                            (negatives != targets[:, None])
                            .astype(np.float32)], axis=1)
    return ids, wmask


def _windows(n, w, rng):
    """(i, j) index pairs of one sequence of length n in the reference's
    order (each i, then j ascending, j != i), with the dynamic window
    b_i ~ U{1..w} drawn from ``rng``."""
    b = rng.randint(1, w + 1, size=n)
    i = np.arange(n)
    lo, hi = np.maximum(0, i - b), np.minimum(n, i + b + 1)
    cnt = hi - lo
    ii = np.repeat(i, cnt)
    jj = np.repeat(lo, cnt) + (np.arange(int(cnt.sum()))
                              - np.repeat(np.cumsum(cnt) - cnt, cnt))
    keep = jj != ii
    return ii[keep], jj[keep]


class _Batches:
    """Stacks example arrays (row-aligned numpy arrays) into batches of
    exactly ``B`` rows; the remainder comes out padded by repetition."""

    def __init__(self, B: int):
        self.B = B
        self._parts: List[tuple] = []
        self._n = 0

    def add(self, *arrays) -> Iterator[tuple]:
        self._parts.append(arrays)
        self._n += len(arrays[0])
        if self._n < self.B:
            return
        cat = [np.concatenate(col) for col in zip(*self._parts)]
        while len(cat[0]) >= self.B:
            yield tuple(a[:self.B] for a in cat)
            cat = [a[self.B:] for a in cat]
        self._parts, self._n = [tuple(cat)], len(cat[0])

    def rest(self) -> Iterator[tuple]:
        if self._n == 0:
            return
        cat = [np.concatenate(col) for col in zip(*self._parts)]
        reps = -(-self.B // len(cat[0]))
        yield tuple(np.concatenate([a] * reps)[:self.B] for a in cat)
        self._parts, self._n = [], 0


def ns_step(w_in, w_out, micro, rows, rmask, denom, targets, negatives,
            lr):
    """One batch of examples, from host arrays: its ``B // micro`` chunks
    (:func:`ns_chunk`) in turn, in place on the tables. Returns the
    batch's loss, summed over the chunks and divided by ``C * micro``, as
    a 0-d tensor left on the device."""
    dev = w_in.device

    def put(a, dtype=torch.int64):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    C = len(targets) // micro
    ids, wmask = _output_rows(np.asarray(targets, np.int64),
                              np.asarray(negatives, np.int64))
    ids, wmask, rows = put(ids), put(wmask, torch.float32), put(rows)
    if rmask is not None:
        rmask, denom = put(rmask, torch.float32), put(denom, torch.float32)
    labels = torch.zeros(ids.shape[1], device=dev)
    labels[0] = 1.0
    total = torch.zeros((), device=dev)
    for k in range(C):
        sl = slice(k * micro, (k + 1) * micro)
        total = total + ns_chunk(
            w_in, w_out, rows[sl], None if rmask is None else rmask[sl],
            None if denom is None else denom[sl], ids[sl], wmask[sl],
            labels, lr)
    return total / (C * micro)


class SequenceVectors:
    """Generic SGNS / CBOW embedding trainer over integer sequences, its
    tables ``[V, D]`` f32 on ``device``."""

    MICRO = 64

    def __init__(self, config: SGNSConfig, vocab: VocabCache,
                 device="cuda"):
        from ..nn.multilayer import resolve_device
        self.config = config
        self.vocab = vocab
        self.device = resolve_device(device)
        rng = np.random.RandomState(config.seed)
        V, D = len(vocab), config.layer_size
        self._w_in = torch.from_numpy(
            (rng.rand(V, D).astype(np.float32) - 0.5) / D).to(self.device)
        self._w_out = torch.zeros((V, D), device=self.device)
        self._table = unigram_table(vocab)
        # numpy's rng.choice(p=table) draws searchsorted(cdf, uniform):
        # the cdf kept here gives the same draws without an O(V) pass each
        self._cdf = np.cumsum(self._table)
        self._cdf /= self._cdf[-1]

    @staticmethod
    def micro_chunk(batch_size: int, micro: int = 64) -> int:
        """Largest divisor of batch_size that is <= micro."""
        return micro_chunk(batch_size, micro)

    def _micro(self) -> int:
        return micro_chunk(self.config.batch_size, self.MICRO)

    # -- device steps ----------------------------------------------------
    def _step(self, rows, rmask, denom, targets, negatives, lr):
        return ns_step(self._w_in, self._w_out, self._micro(), rows, rmask,
                       denom, targets, negatives, lr)

    def _sg_step(self, centers, contexts, negatives, lr):
        return self._step(centers, None, None, contexts, negatives, lr)

    def _cbow_step(self, ctx_mat, ctx_mask, targets, negatives, lr):
        denom = np.maximum(ctx_mask.sum(-1, keepdims=True), 1.0)
        return self._step(ctx_mat, ctx_mask, denom, targets, negatives, lr)

    # -- host-side example generation ------------------------------------
    def _subsample(self, seq: np.ndarray, rng) -> np.ndarray:
        t = self.config.subsample
        if not t:
            return seq
        counts = np.array([self.vocab._by_index[i].count for i in seq],
                          np.float64)
        freq = counts / max(self.vocab.total_word_count, 1)
        keep = (np.sqrt(freq / t) + 1) * (t / np.maximum(freq, 1e-12))
        return seq[rng.rand(len(seq)) < keep]

    def _negatives(self, shape, rng) -> np.ndarray:
        """Negatives ~ the unigram table: the draws (and the stream's use)
        of ``rng.choice(len(table), size, p=table)``."""
        u = rng.random_sample(int(np.prod(shape)))
        return self._cdf.searchsorted(u, side="right").reshape(shape) \
            .astype(np.int64)

    def _sg_batches(self, sequences: Iterable, rng):
        """Skip-gram batches ``(centers [B], contexts [B], negatives [B,
        K])``, the negatives drawn as each batch completes."""
        cfg = self.config
        buf = _Batches(cfg.batch_size)

        def out(batch):
            return batch + (self._negatives((cfg.batch_size, cfg.negative),
                                            rng),)
        for seq in sequences:
            seq = self._subsample(np.asarray(seq, np.int64), rng)
            if len(seq) < 2:
                continue
            i, j = _windows(len(seq), cfg.window, rng)
            for batch in buf.add(seq[i], seq[j]):
                yield out(batch)
        for batch in buf.rest():
            yield out(batch)

    def _cbow_batches(self, sequences: Iterable, rng):
        """CBOW batches ``(ctx_mat [B, 2w], ctx_mask [B, 2w], targets [B],
        negatives [B, K])``: each position's window, padded."""
        cfg = self.config
        W = 2 * cfg.window
        buf = _Batches(cfg.batch_size)

        def out(batch):
            return batch + (self._negatives((cfg.batch_size, cfg.negative),
                                            rng),)
        for seq in sequences:
            seq = self._subsample(np.asarray(seq, np.int64), rng)
            n = len(seq)
            if n < 2:
                continue
            i, j = _windows(n, cfg.window, rng)
            # column of each context within its row: its rank among i's
            first = np.searchsorted(i, np.arange(n))
            col = np.arange(len(i)) - first[i]
            mat = np.zeros((n, W), np.int64)
            mask = np.zeros((n, W), np.float32)
            mat[i, col] = seq[j]
            mask[i, col] = 1.0
            for batch in buf.add(mat, mask, seq):
                yield out(batch)
        for batch in buf.rest():
            yield out(batch)

    # -- training --------------------------------------------------------
    def fit_sequences(self, sequence_supplier: Callable[[], Iterable],
                      listeners: Sequence[Callable] = ()):
        """Train; ``sequence_supplier`` re-yields index sequences each
        epoch. Returns the mean batch loss over every epoch's batches;
        each listener gets ``(epoch, that mean so far)``."""
        cfg = self.config
        rng = np.random.RandomState(cfg.seed)
        total, steps = torch.zeros((), device=self.device), 0
        for epoch in range(cfg.epochs):
            frac = epoch / max(cfg.epochs, 1)
            lr = max(cfg.learning_rate * (1 - frac), cfg.min_learning_rate)
            if cfg.cbow:
                for mat, mask, t, negs in self._cbow_batches(
                        sequence_supplier(), rng):
                    total = total + self._cbow_step(mat, mask, t, negs, lr)
                    steps += 1
            else:
                for c, x, negs in self._sg_batches(sequence_supplier(), rng):
                    total = total + self._sg_step(c, x, negs, lr)
                    steps += 1
            for cb in listeners:
                cb(epoch, float(total) / max(steps, 1))
        return float(total) / max(steps, 1)

    # -- lookup API (reference WordVectors interface) --------------------
    @property
    def syn0(self) -> np.ndarray:
        return self._w_in.cpu().numpy()

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self._w_in[i].cpu().numpy()

    def has_word(self, word: str) -> bool:
        return word in self.vocab

    def similarity(self, w1: str, w2: str) -> float:
        a, b = self.get_word_vector(w1), self.get_word_vector(w2)
        if a is None or b is None:
            return float("nan")
        denom = (np.linalg.norm(a) * np.linalg.norm(b)) or 1e-12
        return float(a @ b / denom)

    def words_nearest(self, word: str, n: int = 10) -> List[str]:
        v = self.get_word_vector(word)
        if v is None:
            return []
        # vocab rows only: ParagraphVectors widens syn0 with doc rows
        # whose indices have no VocabWord behind them
        m = self.syn0[:len(self.vocab)]
        sims = (m @ v) / (np.linalg.norm(m, axis=1) * np.linalg.norm(v)
                          + 1e-12)
        order = np.argsort(-sims)
        me = self.vocab.index_of(word)
        return [self.vocab.word_at(i) for i in order if i != me][:n]
