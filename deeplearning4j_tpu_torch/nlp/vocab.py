"""Vocabulary construction.

The port's own copy of ``deeplearning4j_tpu/nlp/vocab.py`` (numpy and
pure Python, the same classes, codes and tables). Reference:
`deeplearning4j-nlp/.../models/word2vec/wordstore/` — `VocabCache`,
`AbstractCache`, `VocabConstructor`, and `VocabWord` (huffman code
fields used by hierarchical softmax).

Huffman codes / points are padded to a static max depth, so a
hierarchical-softmax path can gather them in one fixed shape.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import Counter
from typing import Dict, Iterable, List, Optional

import numpy as np


@dataclasses.dataclass
class VocabWord:
    """(reference models/word2vec/VocabWord.java)"""
    word: str
    count: int = 0
    index: int = -1
    codes: Optional[List[int]] = None   # huffman code bits
    points: Optional[List[int]] = None  # inner-node indices


class VocabCache:
    """Word ↔ index/count store (reference wordstore/inmemory/AbstractCache.java)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_count = 0

    def __contains__(self, word: str) -> bool:
        return word in self._words

    def __len__(self) -> int:
        return len(self._by_index)

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def word_at(self, index: int) -> str:
        return self._by_index[index].word

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.index if vw else -1

    def word_frequency(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.count if vw else 0

    def words(self) -> List[str]:
        return [v.word for v in self._by_index]

    def add(self, vw: VocabWord):
        vw.index = len(self._by_index)
        self._words[vw.word] = vw
        self._by_index.append(vw)
        self.total_word_count += vw.count


def build_vocab(token_streams: Iterable[List[str]],
                min_word_frequency: int = 5,
                limit: Optional[int] = None) -> VocabCache:
    """Count tokens → frequency-sorted VocabCache
    (reference VocabConstructor.buildJointVocabulary)."""
    counts = Counter()
    for toks in token_streams:
        counts.update(toks)
    cache = VocabCache()
    items = [(w, c) for w, c in counts.items() if c >= min_word_frequency]
    items.sort(key=lambda t: (-t[1], t[0]))
    if limit:
        items = items[:limit]
    for w, c in items:
        cache.add(VocabWord(w, c))
    return cache


def assign_huffman_codes(cache: VocabCache, max_code_length: int = 40):
    """Huffman-code every word for hierarchical softmax
    (reference models/word2vec/Huffman.java)."""
    n = len(cache)
    if n == 0:
        return
    # heap of (count, tiebreak, node); leaves are word indices, inner >= n
    heap = [(cache._by_index[i].count, i, i) for i in range(n)]
    heapq.heapify(heap)
    parent = {}
    binary = {}
    next_id = n
    while len(heap) > 1:
        c1, _, a = heapq.heappop(heap)
        c2, _, b = heapq.heappop(heap)
        parent[a], parent[b] = next_id, next_id
        binary[a], binary[b] = 0, 1
        heapq.heappush(heap, (c1 + c2, next_id, next_id))
        next_id += 1
    root = heap[0][2]
    for i in range(n):
        codes, points = [], []
        node = i
        while node != root:
            codes.append(binary[node])
            points.append(parent[node] - n)  # inner-node index
            node = parent[node]
        codes.reverse()
        points.reverse()
        vw = cache._by_index[i]
        vw.codes = codes[:max_code_length]
        vw.points = points[:max_code_length]


def huffman_arrays(cache: VocabCache, max_code_length: int = 40):
    """Padded [V, L] codes/points + length mask for static-shape HS gathers."""
    n = len(cache)
    L = min(max_code_length,
            max((len(v.codes or []) for v in cache._by_index), default=1))
    codes = np.zeros((n, L), np.int32)
    points = np.zeros((n, L), np.int32)
    mask = np.zeros((n, L), np.float32)
    for i, v in enumerate(cache._by_index):
        k = min(len(v.codes or []), L)
        codes[i, :k] = v.codes[:k]
        points[i, :k] = v.points[:k]
        mask[i, :k] = 1.0
    return codes, points, mask


def unigram_table(cache: VocabCache, power: float = 0.75) -> np.ndarray:
    """Negative-sampling distribution ∝ count^0.75 (reference word2vec impl)."""
    counts = np.array([v.count for v in cache._by_index], np.float64)
    p = counts ** power
    return (p / p.sum()).astype(np.float64)
