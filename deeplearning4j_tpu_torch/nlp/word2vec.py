"""Word2Vec, ParagraphVectors and FastText, and the word-vector file.

Counterpart of ``deeplearning4j_tpu/nlp/word2vec.py`` (the reference's
``Word2Vec.java`` builder, ``ParagraphVectors.java`` PV-DBOW with
``inferVector``, ``FastText.java`` — natively, with hashed subword
n-gram buckets — and ``WordVectorSerializer``). Training runs on the
port's ``SequenceVectors`` step on ``device``; the lookups are numpy.
The file is the JAX package's zip (``vocab.json`` and ``tables.npz``):
each package reads the other's.
"""
from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .sequence_vectors import (SGNSConfig, SequenceVectors, _Batches,
                               micro_chunk, ns_step)
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, build_vocab, unigram_table


class Word2Vec:
    """Skip-gram / CBOW word embeddings (reference Word2Vec.java builder)."""

    class Builder:
        def __init__(self):
            self._cfg = SGNSConfig()
            self._min_word_frequency = 5
            self._iterate: Optional[Iterable[str]] = None
            self._tokenizer: TokenizerFactory = DefaultTokenizerFactory()
            self._limit = None
            self._device = "cuda"

        def min_word_frequency(self, v):
            self._min_word_frequency = v; return self

        def layer_size(self, v):
            self._cfg.layer_size = v; return self

        def window_size(self, v):
            self._cfg.window = v; return self

        def negative_sample(self, v):
            self._cfg.negative = int(v); return self

        def learning_rate(self, v):
            self._cfg.learning_rate = v; return self

        def min_learning_rate(self, v):
            self._cfg.min_learning_rate = v; return self

        def epochs(self, v):
            self._cfg.epochs = v; return self

        def iterations(self, v):  # reference alias: in-loop iterations
            return self

        def batch_size(self, v):
            self._cfg.batch_size = v; return self

        def sampling(self, v):
            self._cfg.subsample = v; return self

        def seed(self, v):
            self._cfg.seed = int(v); return self

        def elements_learning_algorithm(self, name: str):
            self._cfg.cbow = "cbow" in str(name).lower(); return self

        def use_cbow(self, v: bool = True):
            self._cfg.cbow = v; return self

        def limit_vocabulary_size(self, v):
            self._limit = v; return self

        def iterate(self, sentences: Iterable[str]):
            self._iterate = sentences; return self

        def tokenizer_factory(self, tf: TokenizerFactory):
            self._tokenizer = tf; return self

        def device(self, device):
            """Where the tables live and train (the card by default)."""
            self._device = device; return self

        def build(self) -> "Word2Vec":
            return Word2Vec(self._cfg, self._min_word_frequency,
                            self._iterate, self._tokenizer, self._limit,
                            device=self._device)

    @staticmethod
    def builder() -> "Word2Vec.Builder":
        return Word2Vec.Builder()

    def __init__(self, cfg: SGNSConfig, min_word_frequency, sentences,
                 tokenizer: TokenizerFactory, limit=None, device="cuda"):
        self.config = cfg
        self.min_word_frequency = min_word_frequency
        self._sentences = sentences
        self._tokenizer = tokenizer
        self._limit = limit
        self.device = device
        self.vocab: Optional[VocabCache] = None
        self._sv: Optional[SequenceVectors] = None

    def _token_streams(self) -> List[List[str]]:
        return [self._tokenizer.create(s).get_tokens()
                for s in self._sentences]

    def fit(self, listeners: Sequence[Callable] = ()) -> float:
        streams = self._token_streams()
        self.vocab = build_vocab(streams, self.min_word_frequency,
                                 self._limit)
        if len(self.vocab) == 0:
            raise ValueError("empty vocabulary after min_word_frequency "
                             "filter")
        self._sv = SequenceVectors(self.config, self.vocab, self.device)
        idx_streams = [
            np.array([self.vocab.index_of(t) for t in s
                      if self.vocab.index_of(t) >= 0], np.int64)
            for s in streams]
        return self._sv.fit_sequences(lambda: idx_streams, listeners)

    # -- WordVectors surface --------------------------------------------
    def _check(self):
        if self._sv is None:
            raise RuntimeError("call fit() first")

    def get_word_vector(self, word):
        self._check(); return self._sv.get_word_vector(word)

    def get_word_vector_matrix(self) -> np.ndarray:
        self._check(); return self._sv.syn0

    def has_word(self, word):
        self._check(); return self._sv.has_word(word)

    def similarity(self, w1, w2):
        self._check(); return self._sv.similarity(w1, w2)

    def words_nearest(self, word, n=10):
        self._check(); return self._sv.words_nearest(word, n)

    def words_nearest_sum(self, positive: List[str], negative: List[str],
                          n: int = 10) -> List[str]:
        """king - man + woman style analogy (reference wordsNearestSum)."""
        self._check()
        v = np.zeros(self.config.layer_size, np.float32)
        for w in positive:
            vec = self._sv.get_word_vector(w)
            if vec is not None:
                v += vec
        for w in negative:
            vec = self._sv.get_word_vector(w)
            if vec is not None:
                v -= vec
        if not np.any(v):
            return []
        # vocab rows only: ParagraphVectors appends doc rows past the vocab
        m = self._sv.syn0[:len(self.vocab)]
        sims = (m @ v) / (np.linalg.norm(m, axis=1) * np.linalg.norm(v)
                          + 1e-12)
        order = np.argsort(-sims)
        skip = {self.vocab.index_of(w) for w in positive + negative}
        return [self.vocab.word_at(i) for i in order if i not in skip][:n]


class ParagraphVectors(Word2Vec):
    """PV-DBOW document embeddings (reference ParagraphVectors.java).

    Doc vectors are extra rows after the word vocab; each document id
    predicts its words with negative sampling (DBOW). ``infer_vector``
    fits a fresh doc vector by autograd against the frozen tables."""

    class Builder(Word2Vec.Builder):
        def iterate_labeled(self, docs: Sequence):
            """docs: list of (label, text)."""
            self._docs = list(docs); return self

        def build(self) -> "ParagraphVectors":
            pv = ParagraphVectors(self._cfg, self._min_word_frequency,
                                  None, self._tokenizer, self._limit,
                                  device=self._device)
            pv._docs = getattr(self, "_docs", [])
            return pv

    @staticmethod
    def builder() -> "ParagraphVectors.Builder":
        return ParagraphVectors.Builder()

    def fit(self, listeners: Sequence[Callable] = ()) -> float:
        streams = [self._tokenizer.create(t).get_tokens()
                   for _, t in self._docs]
        self.vocab = build_vocab(streams, self.min_word_frequency,
                                 self._limit)
        if len(self.vocab) == 0:
            raise ValueError("empty vocabulary")
        self.labels = [lbl for lbl, _ in self._docs]
        nwords, ndocs = len(self.vocab), len(self._docs)
        cfg = self.config
        sv = self._sv = SequenceVectors(cfg, self.vocab, self.device)
        # widen the tables with one row per document
        rng = np.random.RandomState(cfg.seed + 1)
        doc_rows = (rng.rand(ndocs, cfg.layer_size).astype(np.float32)
                    - 0.5) / cfg.layer_size
        sv._w_in = torch.cat([sv._w_in, torch.from_numpy(doc_rows).to(
            sv.device)])
        sv._w_out = torch.cat([sv._w_out, sv._w_out.new_zeros(
            (ndocs, cfg.layer_size))])
        doc_streams = []
        for d, s in enumerate(streams):
            ids = [self.vocab.index_of(t) for t in s]
            doc_streams.append((nwords + d, np.array(
                [i for i in ids if i >= 0], np.int64)))
        total = self._fit_dbow(doc_streams, listeners)
        self._nwords = nwords
        return total

    def _fit_dbow(self, doc_streams, listeners):
        """(doc, word) pairs, batched and stepped as skip-gram pairs."""
        cfg = self.config
        sv = self._sv
        rng = np.random.RandomState(cfg.seed)
        total, steps = torch.zeros((), device=sv.device), 0
        for epoch in range(cfg.epochs):
            lr = max(cfg.learning_rate * (1 - epoch / max(cfg.epochs, 1)),
                     cfg.min_learning_rate)
            buf = _Batches(cfg.batch_size)

            def run(batches):
                nonlocal total, steps
                for c, x in batches:
                    negs = sv._negatives((cfg.batch_size, cfg.negative),
                                         rng)
                    total = total + sv._sg_step(c, x, negs, lr)
                    steps += 1
            for doc_id, words in doc_streams:
                run(buf.add(np.full(len(words), doc_id, np.int64), words))
            run(buf.rest())
            for cb in listeners:
                cb(epoch, float(total) / max(steps, 1))
        return float(total) / max(steps, 1)

    def get_paragraph_vector(self, label) -> np.ndarray:
        d = self.labels.index(label)
        return self._sv._w_in[self._nwords + d].cpu().numpy()

    def infer_vector(self, text: str, steps: int = 50,
                     lr: float = 0.05) -> np.ndarray:
        """Gradient-fit a fresh doc vector against the frozen tables
        (reference ParagraphVectors.inferVector)."""
        toks = self._tokenizer.create(text).get_tokens()
        ids = np.array([self.vocab.index_of(t) for t in toks
                        if self.vocab.index_of(t) >= 0], np.int64)
        if len(ids) == 0:
            return np.zeros(self.config.layer_size, np.float32)
        rng = np.random.RandomState(0)
        dev = self._sv.device
        v = torch.from_numpy((rng.rand(self.config.layer_size)
                              .astype(np.float32) - 0.5)
                             / self.config.layer_size).to(dev)
        w_out = self._sv._w_out
        ids_t = torch.from_numpy(ids).to(dev)

        def grad(vec, negs):
            vec = vec.detach().requires_grad_(True)
            with torch.enable_grad():
                pos = w_out[ids_t] @ vec
                neg = w_out[negs] @ vec                   # [N, K]
                neg_mask = (negs != ids_t[:, None]).to(neg.dtype)
                loss = -(torch.sum(F.logsigmoid(pos))
                         + torch.sum(F.logsigmoid(-neg) * neg_mask)) \
                    / len(ids)
                return torch.autograd.grad(loss, vec)[0]

        from ..runtime.inference import counted_dispatch
        grad = counted_dispatch(grad, tag=f"pv_infer:{id(self)}")
        for _ in range(steps):
            negs = torch.from_numpy(self._sv._negatives(
                (len(ids), self.config.negative), rng)).to(dev)
            v = v - lr * grad(v, negs)
        return v.cpu().numpy()

    def similarity_to_label(self, text: str, label: str) -> float:
        a = self.infer_vector(text)
        b = self.get_paragraph_vector(label)
        return float(a @ b / ((np.linalg.norm(a) * np.linalg.norm(b))
                              or 1e-12))


class FastText:
    """Subword-enriched embeddings (reference models/fasttext/FastText.java,
    there a JNI wrapper; here native: hashed char n-gram buckets, trained
    with the SGNS step whose input vector is the mean of the word row and
    its n-gram rows, so an unseen word gets a vector from its subwords)."""

    def __init__(self, layer_size=100, window=5, negative=5, epochs=1,
                 min_word_frequency=1, min_n=3, max_n=6, buckets=200_000,
                 learning_rate=0.05, seed=0, batch_size=2048,
                 max_grams_per_word=24, device="cuda"):
        from ..nn.multilayer import resolve_device
        self.cfg = SGNSConfig(layer_size=layer_size, window=window,
                              negative=negative, epochs=epochs,
                              learning_rate=learning_rate, seed=seed,
                              batch_size=batch_size)
        self.min_word_frequency = min_word_frequency
        self.min_n, self.max_n, self.buckets = min_n, max_n, buckets
        self.max_grams = max_grams_per_word
        self.device = resolve_device(device)
        self._tokenizer = DefaultTokenizerFactory()

    def _ngrams(self, word: str) -> List[int]:
        w = f"<{word}>"
        out = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(w) - n + 1):
                # stable fnv-1a so vectors are reproducible across runs
                h = 2166136261
                for ch in w[i:i + n].encode():
                    h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
                out.append(h % self.buckets)
        return out[: self.max_grams]

    def fit(self, sentences: Iterable[str]) -> float:
        cfg = self.cfg
        streams = [self._tokenizer.create(s).get_tokens() for s in sentences]
        self.vocab = build_vocab(streams, self.min_word_frequency)
        V, D, G = len(self.vocab), cfg.layer_size, self.max_grams
        rng = np.random.RandomState(cfg.seed)
        self._w_in = torch.from_numpy(
            (rng.rand(V + self.buckets, D).astype(np.float32) - 0.5)
            / D).to(self.device)
        self._w_out = torch.zeros((V, D), device=self.device)
        # padded per-word gram ids [V, G] (offset by V) and their mask
        gram_mat = np.zeros((V, G), np.int64)
        gram_mask = np.zeros((V, G), np.float32)
        for i, w in enumerate(self.vocab.words()):
            gs = self._ngrams(w)
            gram_mat[i, :len(gs)] = [V + g for g in gs]
            gram_mask[i, :len(gs)] = 1.0
        self._table = unigram_table(self.vocab)
        # the input rows of a word: itself, then its n-grams; their mean
        rows_of = np.concatenate([np.arange(V)[:, None], gram_mat], axis=1)
        mask_of = np.concatenate([np.ones((V, 1), np.float32), gram_mask],
                                 axis=1)
        denom_of = 1.0 + gram_mask.sum(-1, keepdims=True)
        S = micro_chunk(cfg.batch_size)

        def step(w_in, w_out, c, x, negs, lr):
            return ns_step(w_in, w_out, S, rows_of[c], mask_of[c],
                           denom_of[c], x, negs, lr)

        from ..runtime.inference import counted_dispatch
        step = counted_dispatch(step, tag=f"fasttext:{id(self)}")

        idx_streams = [np.array([self.vocab.index_of(t) for t in s
                                 if self.vocab.index_of(t) >= 0], np.int64)
                       for s in streams]
        total, steps = torch.zeros((), device=self.device), 0
        pair_rng = np.random.RandomState(cfg.seed)
        pairs = SequenceVectors(cfg, self.vocab, "cpu")  # its pair stream
        for epoch in range(cfg.epochs):
            lr = max(cfg.learning_rate * (1 - epoch / max(cfg.epochs, 1)),
                     cfg.min_learning_rate)
            for c, x, negs in pairs._sg_batches(idx_streams, pair_rng):
                total = total + step(self._w_in, self._w_out, c, x, negs,
                                     lr)
                steps += 1
        return float(total) / max(steps, 1)

    def get_word_vector(self, word: str) -> np.ndarray:
        """The word row and its n-gram rows, averaged; an unseen word gets
        a vector from its subwords alone."""
        w_in = self._w_in.cpu().numpy()
        V = len(self.vocab)
        i = self.vocab.index_of(word)
        vecs = [w_in[i]] if i >= 0 else []
        vecs.extend(w_in[V + g] for g in self._ngrams(word))
        if not vecs:  # unseen and too short for any n-gram
            return np.zeros(self.cfg.layer_size, np.float32)
        return np.mean(vecs, axis=0)

    def similarity(self, w1, w2) -> float:
        a, b = self.get_word_vector(w1), self.get_word_vector(w2)
        return float(a @ b / ((np.linalg.norm(a) * np.linalg.norm(b))
                              or 1e-12))


# -- serialization (reference WordVectorSerializer) -----------------------
def write_word_vectors(model: Word2Vec, path: str):
    """Zip of the vocab json and the f32 tables (reference
    writeWord2VecModel). ParagraphVectors tables carry doc rows past the
    vocab; their labels are kept so the reader can rebuild them."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        meta = {"words": model.vocab.words(),
                "counts": [model.vocab.word_frequency(w)
                           for w in model.vocab.words()],
                "config": dataclasses.asdict(model.config)}
        if isinstance(model, ParagraphVectors):
            meta["labels"] = list(model.labels)
        z.writestr("vocab.json", json.dumps(meta))
        buf = io.BytesIO()
        np.savez(buf, syn0=model._sv._w_in.cpu().numpy(),
                 syn1neg=model._sv._w_out.cpu().numpy())
        z.writestr("tables.npz", buf.getvalue())


def read_word_vectors(path: str, device="cuda") -> Word2Vec:
    """The model of :func:`write_word_vectors`' file (the JAX package's
    too), its tables on ``device``."""
    from .vocab import VocabWord
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("vocab.json"))
        tables = np.load(io.BytesIO(z.read("tables.npz")))
    cfg = SGNSConfig(**meta["config"])
    vocab = VocabCache()
    for w, c in zip(meta["words"], meta["counts"]):
        vocab.add(VocabWord(w, c))
    labels = meta.get("labels")
    if labels is not None:
        m = ParagraphVectors(cfg, 1, [], DefaultTokenizerFactory(),
                             device=device)
        m.labels = list(labels)
        m._nwords = len(vocab)
    else:
        m = Word2Vec(cfg, 1, [], DefaultTokenizerFactory(), device=device)
    m.vocab = vocab
    m._sv = SequenceVectors(cfg, vocab, device)
    m._sv._w_in = torch.from_numpy(tables["syn0"]).to(m._sv.device)
    m._sv._w_out = torch.from_numpy(tables["syn1neg"]).to(m._sv.device)
    return m
