"""Graph embeddings: DeepWalk + random-walk iterators.

Counterpart of ``deeplearning4j_tpu/nlp/deepwalk.py``; the walks are
numpy on the host, the skip-gram training the port's
``SequenceVectors`` on ``device``. Reference:
`deeplearning4j-graph/src/main/java/org/deeplearning4j/graph/` —
`api/IGraph`, `graph/Graph.java`, `iterator/RandomWalkIterator.java`,
`iterator/WeightedRandomWalkIterator.java`, `models/deepwalk/DeepWalk.java`
(skip-gram over vertex walks, hierarchical-softmax there; negative sampling
here — same objective family, batched on device).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .sequence_vectors import SGNSConfig, SequenceVectors
from .vocab import VocabCache, VocabWord


class Graph:
    """Adjacency-list graph (reference graph/Graph.java)."""

    def __init__(self, num_vertices: int, allow_multiple_edges: bool = False):
        self.num_vertices = num_vertices
        self._adj: List[List[Tuple[int, float]]] = [[] for _ in range(num_vertices)]
        self._allow_multi = allow_multiple_edges

    def add_edge(self, a: int, b: int, weight: float = 1.0,
                 directed: bool = False):
        if not self._allow_multi and any(v == b for v, _ in self._adj[a]):
            return
        self._adj[a].append((b, weight))
        if not directed:
            self._adj[b].append((a, weight))

    def get_connected_vertices(self, v: int) -> List[int]:
        return [u for u, _ in self._adj[v]]

    def degree(self, v: int) -> int:
        return len(self._adj[v])


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex
    (reference iterator/RandomWalkIterator.java)."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 0,
                 weighted: bool = False):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.weighted = weighted

    def walks(self, rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random.RandomState(self.seed)
        order = rng.permutation(self.graph.num_vertices)
        for start in order:
            walk = [int(start)]
            cur = int(start)
            for _ in range(self.walk_length - 1):
                nbrs = self.graph._adj[cur]
                if not nbrs:
                    break
                if self.weighted:
                    ws = np.array([w for _, w in nbrs], np.float64)
                    cur = nbrs[rng.choice(len(nbrs), p=ws / ws.sum())][0]
                else:
                    cur = nbrs[rng.randint(len(nbrs))][0]
                walk.append(cur)
            yield np.array(walk, np.int64)


class DeepWalk:
    """Vertex embeddings via skip-gram on random walks
    (reference models/deepwalk/DeepWalk.java Builder: vectorSize, windowSize,
    learningRate; fit(GraphWalkIterator))."""

    class Builder:
        def __init__(self):
            self._size, self._window, self._lr, self._seed = 100, 5, 0.025, 0
            self._epochs, self._negative = 1, 5
            self._device = "cuda"

        def vector_size(self, v):
            self._size = v; return self

        def window_size(self, v):
            self._window = v; return self

        def learning_rate(self, v):
            self._lr = v; return self

        def seed(self, v):
            self._seed = v; return self

        def epochs(self, v):
            self._epochs = v; return self

        def negative_sample(self, v):
            self._negative = v; return self

        def device(self, device):
            """Where the tables live and train (the card by default)."""
            self._device = device; return self

        def build(self) -> "DeepWalk":
            return DeepWalk(self._size, self._window, self._lr, self._seed,
                            self._epochs, self._negative,
                            device=self._device)

    @staticmethod
    def builder():
        return DeepWalk.Builder()

    def __init__(self, size, window, lr, seed, epochs, negative,
                 device="cuda"):
        self.cfg = SGNSConfig(layer_size=size, window=window,
                              learning_rate=lr, seed=seed, epochs=epochs,
                              negative=negative, subsample=0.0,
                              batch_size=1024)
        self.device = device
        self._sv: Optional[SequenceVectors] = None

    def fit(self, walk_iterator: RandomWalkIterator) -> float:
        g = walk_iterator.graph
        vocab = VocabCache()
        degs = [max(g.degree(v), 1) for v in range(g.num_vertices)]
        for v in range(g.num_vertices):
            vocab.add(VocabWord(str(v), degs[v]))
        self._sv = SequenceVectors(self.cfg, vocab, self.device)
        rng = np.random.RandomState(self.cfg.seed)
        return self._sv.fit_sequences(lambda: walk_iterator.walks(rng))

    def get_vertex_vector(self, v: int) -> np.ndarray:
        return self._sv._w_in[v].cpu().numpy()

    def similarity(self, a: int, b: int) -> float:
        return self._sv.similarity(str(a), str(b))

    def verify_connectivity_structure(self):  # convenience for tests
        return self._sv is not None
