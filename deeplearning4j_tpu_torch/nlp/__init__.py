"""NLP: embeddings, tokenization, vocab (reference deeplearning4j-nlp-parent
+ deeplearning4j-graph). Counterpart of ``deeplearning4j_tpu/nlp/``, the
same names; the trainers run on ``device`` (the card by default)."""
from .deepwalk import DeepWalk, Graph, RandomWalkIterator
from .sequence_vectors import SGNSConfig, SequenceVectors
from .tokenization import (CommonPreprocessor, DefaultTokenizerFactory,
                           EndingPreProcessor, LowCasePreProcessor,
                           NGramTokenizerFactory, TokenizerFactory)
from .vocab import (VocabCache, VocabWord, assign_huffman_codes, build_vocab,
                    huffman_arrays, unigram_table)
from .word2vec import (FastText, ParagraphVectors, Word2Vec,
                       read_word_vectors, write_word_vectors)

__all__ = [
    "Word2Vec", "ParagraphVectors", "FastText", "SequenceVectors",
    "SGNSConfig", "DeepWalk", "Graph", "RandomWalkIterator",
    "VocabCache", "VocabWord", "build_vocab", "assign_huffman_codes",
    "huffman_arrays", "unigram_table",
    "DefaultTokenizerFactory", "NGramTokenizerFactory", "TokenizerFactory",
    "CommonPreprocessor", "LowCasePreProcessor", "EndingPreProcessor",
    "read_word_vectors", "write_word_vectors",
]
