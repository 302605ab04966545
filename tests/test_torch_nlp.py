"""The port's NLP package (``deeplearning4j_tpu_torch/nlp``) against the
JAX package's ``nlp``: tokenizers, vocab, Huffman codes and the unigram
table exactly; the trainers (``SequenceVectors`` skip-gram and CBOW,
``Word2Vec``, ``ParagraphVectors``, ``FastText``, ``DeepWalk``) from the
same seed on the same tiny corpora; the word-vector zip read across
packages. The port runs on the CPU.

Tolerances, each with its reason:
- tables after training: atol 1e-5 (``TABLES``). Both sides draw the
  same pairs, windows, subsampling and negatives from the same numpy
  streams; the port's closed-form update, added row by row with
  ``index_add_``, and the JAX package's dense autodiff gradient differ
  only in f32 rounding (~1e-7 a chunk, over a few hundred chunks);
- mean losses: rtol 1e-5 (``LOSS_RTOL``);
- a file read by the other package: exact (the same f32 arrays).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu import nlp as jn
from deeplearning4j_tpu.nlp import sequence_vectors as jsv
from deeplearning4j_tpu.ops.registry import exec_op as jexec

from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch import nlp as tn
from deeplearning4j_tpu_torch.nlp import sequence_vectors as tsv
from deeplearning4j_tpu_torch.ops import exec_op

TABLES = dict(atol=1e-5, rtol=0)
LOSS_RTOL = 1e-5


def corpus(n=60, seed=0):
    """Two topic clusters, as the JAX package's ``tests/test_nlp.py``:
    words inside a topic co-occur, across topics never."""
    rng = np.random.RandomState(seed)
    animals = ["cat", "dog", "pet", "fur", "paw"]
    cars = ["car", "road", "drive", "wheel", "fuel"]
    return [" ".join(rng.choice(animals if rng.rand() < 0.5 else cars,
                                size=8)) for _ in range(n)]


# -- tokenization and vocab ---------------------------------------------------------

@pytest.mark.parametrize("pre", [None, "CommonPreprocessor",
                                 "LowCasePreProcessor",
                                 "EndingPreProcessor"])
@pytest.mark.parametrize("factory", ["DefaultTokenizerFactory",
                                     "NGramTokenizerFactory"])
def test_tokenizers_match_jax(factory, pre):
    text = "Hello, World! The cats were running 3 times (quickly)."
    out = []
    for ns in (jn, tn):
        tf = getattr(ns, factory)()
        if pre:
            tf.set_token_pre_processor(getattr(ns, pre)())
        out.append(tf.create(text).get_tokens())
    assert out[0] == out[1] and out[0]


def test_vocab_huffman_and_unigram_table_match_jax():
    streams = [s.split() for s in corpus(40)] + [["rare"], ["cat"] * 9]
    jv, tv = jn.build_vocab(streams, 1), tn.build_vocab(streams, 1)
    assert tv.words() == jv.words()
    assert [tv.word_frequency(w) for w in tv.words()] == \
        [jv.word_frequency(w) for w in jv.words()]
    assert tv.index_of("nope") == -1 and len(tv) == len(jv)
    jn.assign_huffman_codes(jv)
    tn.assign_huffman_codes(tv)
    for w in tv.words():
        assert tv.word_for(w).codes == jv.word_for(w).codes
        assert tv.word_for(w).points == jv.word_for(w).points
    for a, b in zip(tn.huffman_arrays(tv), jn.huffman_arrays(jv)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tn.unigram_table(tv), jn.unigram_table(jv))
    assert len(tn.build_vocab(streams, 2, limit=3)) == 3


def test_example_stream_is_the_jax_pair_generator():
    """The vectorized windows give the JAX generator's pairs, in order,
    from the same stream (negatives drawn after each full batch)."""
    seqs = [np.arange(n, dtype=np.int64) % 7 for n in (1, 9, 2, 14)]
    cfg = jsv.SGNSConfig(window=3, batch_size=8, negative=2)
    vocab = jn.build_vocab([[str(i) for i in range(7)]], 1)
    j = jsv.SequenceVectors(cfg, vocab)
    t = tsv.SequenceVectors(tsv.SGNSConfig(window=3, batch_size=8,
                                           negative=2), vocab, "cpu")
    # the JAX epoch loop without its step: a lazy pair generator and the
    # negatives drawn from the same stream each time the buffer fills
    rng, pairs, negs, buf = np.random.RandomState(5), [], [], 0
    for c, x in j._pairs(seqs, rng):
        pairs.append((int(c), int(x)))
        buf += 1
        if buf == 8:
            negs.append(j._negatives((8, 2), rng))
            buf = 0
    if buf:
        negs.append(j._negatives((8, 2), rng))
    batches = list(t._sg_batches(seqs, np.random.RandomState(5)))
    got = [(int(c), int(x)) for b in batches for c, x in zip(b[0], b[1])]
    assert len(batches) == len(negs) == -(-len(pairs) // 8)
    assert got[:len(pairs)] == pairs
    # the last batch padded by repetition
    assert buf and got[len(pairs):] == (pairs[-buf:] * 8)[buf:8]
    for b, n in zip(batches, negs):
        np.testing.assert_array_equal(b[2], n)


@pytest.mark.parametrize("batch,want", [(2048, 64), (100, 50), (97, 1),
                                        (16, 16)])
def test_micro_chunk(batch, want):
    assert tsv.micro_chunk(batch) == jsv.micro_chunk(batch) == want


# -- trainers against the JAX package -------------------------------------------------

def _w2v(ns, cbow, sub, device=None, epochs=2):
    b = (ns.Word2Vec.builder().min_word_frequency(1).layer_size(8)
         .window_size(3).negative_sample(3).epochs(epochs).batch_size(96)
         .seed(4).sampling(sub).use_cbow(cbow).iterate(corpus()))
    if device:
        b = b.device(device)
    return b.build()


@pytest.mark.parametrize("sub", [0.0, 0.05])
@pytest.mark.parametrize("cbow", [False, True], ids=["skipgram", "cbow"])
def test_sequence_vectors_tables_match_jax(cbow, sub):
    j, t = _w2v(jn, cbow, sub), _w2v(tn, cbow, sub, "cpu")
    np.testing.assert_allclose(t.fit(), j.fit(), rtol=LOSS_RTOL)
    assert t.vocab.words() == j.vocab.words()
    np.testing.assert_allclose(t._sv.syn0, j._sv.syn0, **TABLES)
    np.testing.assert_allclose(t._sv._w_out.numpy(),
                               np.asarray(j._sv._w_out), **TABLES)


def test_fasttext_matches_jax():
    j = jn.FastText(layer_size=8, epochs=1, batch_size=64, buckets=500,
                    seed=3)
    t = tn.FastText(layer_size=8, epochs=1, batch_size=64, buckets=500,
                    seed=3, device="cpu")
    np.testing.assert_allclose(t.fit(corpus(30)), j.fit(corpus(30)),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(t._w_in.numpy(), np.asarray(j._w_in),
                               **TABLES)
    for w in ("cat", "catt", "ab"):   # in vocab, unseen, no n-grams
        np.testing.assert_allclose(t.get_word_vector(w),
                                   j.get_word_vector(w), **TABLES)


def _docs(n=5):
    docs = [("animals", "cat dog pet cat dog pet cat dog"),
            ("vehicles", "car road drive car road drive car road")] * n
    return [(f"{lbl}{i}", txt) for i, (lbl, txt) in enumerate(docs)]


def _pv(ns, device=None):
    b = (ns.ParagraphVectors.builder().min_word_frequency(1).layer_size(8)
         .epochs(2).batch_size(64).seed(7).iterate_labeled(_docs()))
    if device:
        b = b.device(device)
    return b.build()


def test_paragraph_vectors_and_infer_vector_match_jax():
    j, t = _pv(jn), _pv(tn, "cpu")
    np.testing.assert_allclose(t.fit(), j.fit(), rtol=LOSS_RTOL)
    np.testing.assert_allclose(t._sv.syn0, j._sv.syn0, **TABLES)
    np.testing.assert_allclose(t.get_paragraph_vector("animals0"),
                               j.get_paragraph_vector("animals0"), **TABLES)
    np.testing.assert_allclose(t.infer_vector("cat dog pet"),
                               j.infer_vector("cat dog pet"), **TABLES)
    assert all(t.has_word(w) for w in t.words_nearest("cat", n=5))


def test_deepwalk_matches_jax():
    out = []
    for ns, kw in ((jn, {}), (tn, {"device": "cpu"})):
        g = ns.Graph(12)
        for base in (0, 6):
            for a in range(base, base + 6):
                for b in range(a + 1, base + 6):
                    g.add_edge(a, b)
        g.add_edge(5, 6)
        bld = (ns.DeepWalk.builder().vector_size(8).window_size(3).epochs(2)
               .seed(0))
        dw = (bld.device(kw["device"]) if kw else bld).build()
        dw.fit(ns.RandomWalkIterator(g, walk_length=12, seed=0))
        out.append(np.stack([dw.get_vertex_vector(v) for v in range(12)]))
    np.testing.assert_allclose(out[1], out[0], **TABLES)


# -- the port on its own -----------------------------------------------------------------

@pytest.fixture(scope="module")
def w2v():
    m = (tn.Word2Vec.builder().min_word_frequency(1).layer_size(32)
         .window_size(3).negative_sample(5).epochs(3).batch_size(512)
         .seed(42).iterate(corpus(300)).device("cpu").build())
    m.fit()
    return m


def test_topics_cluster_and_lookups(w2v):
    """The JAX package's TestWord2Vec on the port."""
    assert w2v.similarity("cat", "dog") > w2v.similarity("cat", "road")
    assert set(w2v.words_nearest("car", 3)) <= {"road", "drive", "wheel",
                                                "fuel"}
    assert w2v.get_word_vector("cat").shape == (32,)
    assert w2v.get_word_vector("notaword") is None
    near = w2v.words_nearest_sum(["cat", "dog"], ["road"], n=2)
    assert set(near) <= {"pet", "fur", "paw"}


@pytest.mark.parametrize("kind", ["word2vec", "paragraph_vectors"])
def test_word_vector_files_cross_packages(kind, tmp_path):
    if kind == "word2vec":
        j, t = _w2v(jn, False, 0.0, epochs=1), _w2v(tn, False, 0.0, "cpu",
                                                    epochs=1)
    else:
        j, t = _pv(jn), _pv(tn, "cpu")
    j.fit()
    t.fit()
    jp, tp = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    jn.write_word_vectors(j, jp)
    tn.write_word_vectors(t, tp)
    from_jax = tn.read_word_vectors(jp, device="cpu")
    from_port = jn.read_word_vectors(tp)
    assert type(from_jax).__name__ == type(j).__name__
    assert type(from_port).__name__ == type(t).__name__
    np.testing.assert_array_equal(from_jax.get_word_vector_matrix(),
                                  j.get_word_vector_matrix())
    np.testing.assert_array_equal(from_port.get_word_vector_matrix(),
                                  t.get_word_vector_matrix())
    assert from_jax.similarity("cat", "dog") == pytest.approx(
        j.similarity("cat", "dog"), rel=1e-6)
    assert from_jax.vocab.words() == j.vocab.words()
    if kind == "paragraph_vectors":
        assert from_jax.labels == j.labels
        np.testing.assert_array_equal(
            from_jax.get_paragraph_vector("vehicles1"),
            j.get_paragraph_vector("vehicles1"))


def test_bridge_loads_jax_tables():
    j = _w2v(jn, False, 0.0, epochs=1)
    j.fit()
    t = _w2v(tn, False, 0.0, "cpu", epochs=1)
    t.fit()
    bridge.load_sequence_vectors(t, np.asarray(j._sv._w_in) + 1.0,
                                 np.asarray(j._sv._w_out))
    np.testing.assert_array_equal(t.get_word_vector("cat"),
                                  j.get_word_vector("cat") + 1.0)
    with pytest.raises(ValueError, match="tables of shape"):
        bridge.load_sequence_vectors(t, np.zeros((2, 8), np.float32),
                                     np.zeros((2, 8), np.float32))


def test_nlp_ops_return_new_tables():
    """skipgram / cbow are functional: the input tables are left as they
    were, and a row named twice gets both updates."""
    r = np.random.RandomState(0)
    syn0, syn1 = (torch.from_numpy(r.randn(5, 4).astype(np.float32))
                  for _ in range(2))
    before = syn0.clone(), syn1.clone()
    t = torch.tensor([1, 1], dtype=torch.int32)
    c = torch.tensor([2, 3], dtype=torch.int32)
    n = torch.tensor([[4], [0]], dtype=torch.int32)
    s0, s1, loss = exec_op("skipgram", syn0, syn1, t, c, n, lr=0.1)
    assert torch.equal(syn0, before[0]) and torch.equal(syn1, before[1])
    j0, j1, jl = jexec("skipgram", *[jnp.asarray(a.numpy())
                                     for a in (syn0, syn1, t, c, n)], lr=0.1)
    np.testing.assert_allclose(s0.numpy(), np.asarray(j0), atol=1e-6)
    np.testing.assert_allclose(s1.numpy(), np.asarray(j1), atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert not torch.equal(s0[1], syn0[1])


def test_trainers_need_a_device_they_can_use():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _w2v(tn, False, 0.0).fit()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tn.FastText(layer_size=8)
