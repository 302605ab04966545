"""The port's record iterators and the data pipeline as a whole against
the JAX package's, on the same records and the same weights.

- ``RecordReaderDataSetIterator`` (classification, regression with one
  or several label columns, unsupervised, image records, a
  ``TransformProcess`` pre-pass) and ``SequenceRecordReaderDataSetIterator``
  (ALIGN_START and ALIGN_END, with their masks): features, labels and
  masks equal exactly (``device="cpu"``: both sides cast the same float64
  values to float32).
- The whole path: a CSV through a ``TransformProcess`` into an MLP's
  ``fit``, and a small LeNet-shaped network fitted 3 steps from each
  side's own ``NativeBatchDataSetIterator`` with the same seed (so the
  same batches), both bridged from the JAX network's initial weights
  (``bridge.load_multilayer``). Adam at lr 1e-3: params held to atol
  1e-4 (0.1 * lr: a weight whose f32 gradient, summed in another order,
  is ~0 could move by up to lr a step either way; on these batches none
  does), the last loss to rtol 1e-5 (f32 products and convolutions summed
  in another order).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.etl as JE
import deeplearning4j_tpu.learning as jlearn
import deeplearning4j_tpu.nn.conf.layers as JL
import deeplearning4j_tpu_torch.etl as TE
from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.datasets import iterators as jiters
from deeplearning4j_tpu.datasets import record_iterator as jrec
from deeplearning4j_tpu.nn.conf.config import (InputType as JInputType,
                                               NeuralNetConfiguration as JNNC)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch import native as tnative
from deeplearning4j_tpu_torch.datasets import iterators as titers
from deeplearning4j_tpu_torch.datasets import record_iterator as trec
from deeplearning4j_tpu_torch.nn.conf.config import \
    MultiLayerConfiguration as TConf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN

ADAM_ATOL, LOSS_RTOL = 1e-4, 1e-5
SIDES = ((JE, jrec, {}), (TE, trec, {"device": "cpu"}))


def _arrays(ds, jax_side):
    def arr(a):
        if a is None:
            return None
        return np.asarray(a.jax()) if jax_side else a.numpy()
    return [arr(ds.features), arr(ds.labels), arr(ds.features_mask),
            arr(ds.labels_mask)]


def _drain(it, jax_side):
    out = []
    while it.has_next():
        out.append(_arrays(it.next(), jax_side))
    return out


def _same_batches(t, j):
    assert len(t) == len(j) > 0
    for tb, jb in zip(t, j):
        for a, b in zip(tb, jb):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)


CSV = "1.0,2.0,0\n3.0,4.5,1\n5.0,6.0,2\n7.0,8.0,1\n9.5,1.0,0\n"
RECORD_CASES = {
    "classification": (lambda E: E.CSVRecordReader().initialize(
        E.StringSplit(CSV)), {"label_index": 2, "num_classes": 3}),
    "label_first": (lambda E: E.CSVRecordReader().initialize(
        E.StringSplit(CSV)), {"label_index": 0, "num_classes": 10}),
    "regression": (lambda E: E.CollectionRecordReader(
        [[1.0, 2.0, 10.0], [3.0, 4.0, 20.0], [5, 6, 30]]).initialize(),
        {"label_index": 2, "regression": True}),
    "multi_regression": (lambda E: E.CollectionRecordReader(
        [[1.0, 5.0, 6.0], [2.0, 7.0, 8.0], [3, 9, 1]]).initialize(),
        {"label_index": 1, "label_index_to": 2, "regression": True}),
    "no_classes": (lambda E: E.CSVRecordReader().initialize(
        E.StringSplit(CSV)), {"label_index": -1}),
    "unsupervised": (lambda E: E.CSVRecordReader().initialize(
        E.StringSplit(CSV)), {"label_index": None}),
    "transform_process": (lambda E: E.CSVRecordReader().initialize(
        E.StringSplit("a,SF,1.5,0\nb,LA,2.5,1\nc,SF,3.5,1\n")),
        {"label_index": -1, "num_classes": 2, "transform_process": "tp"}),
}


def _tp(E):
    schema = (E.Schema.Builder().add_column_string("name")
              .add_column_categorical("city", ["SF", "LA"])
              .add_column_double("v").add_column_integer("label").build())
    return (E.TransformProcess.Builder(schema).remove_columns("name")
            .categorical_to_one_hot("city").double_math_op("v", "Multiply", 2)
            .build())


@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_record_reader_iterator_matches_jax(case):
    make_reader, kw = RECORD_CASES[case]
    got = []
    for E, mod, dev in SIDES:
        kw_ = dict(kw, **dev)
        if kw_.get("transform_process") == "tp":
            kw_["transform_process"] = _tp(E)
        it = mod.RecordReaderDataSetIterator(make_reader(E), 2, **kw_)
        first = _drain(it, E is JE)
        it.reset()
        got.append((first, _drain(it, E is JE), it.total_examples()))
    (j_first, j_again, jn), (t_first, t_again, tn) = got
    _same_batches(t_first, j_first)
    _same_batches(t_again, t_first)
    assert tn == jn


def test_image_records_through_the_iterator_match_jax(tmp_path):
    from PIL import Image
    rs = np.random.RandomState(0)
    for label in ("cat", "dog"):
        os.makedirs(tmp_path / label)
        for i in range(3):
            Image.fromarray((rs.rand(10, 12, 3) * 255).astype(np.uint8)).save(
                tmp_path / label / f"{i}.png")
    got = []
    for E, mod, dev in SIDES:
        rr = E.ImageRecordReader(10, 12, 3, E.ParentPathLabelGenerator())
        rr.initialize(E.FileSplit(str(tmp_path), [".png"]))
        it = mod.RecordReaderDataSetIterator(rr, 4, label_index=1,
                                             num_classes=2, **dev)
        got.append(_drain(it, E is JE))
    _same_batches(got[1], got[0])
    assert got[1][0][0].shape == (4, 3, 10, 12)


@pytest.mark.parametrize("align", ["ALIGN_START", "ALIGN_END"])
@pytest.mark.parametrize("classes", [2, None])
def test_sequence_iterator_matches_jax(align, classes, tmp_path):
    (tmp_path / "s0.csv").write_text("1,2,0\n3,4,1\n5,6,0\n")
    (tmp_path / "s1.csv").write_text("7,8,1\n9,10,0\n")
    (tmp_path / "s2.csv").write_text("0.5,1.5,1\n")
    got = []
    for E, mod, dev in SIDES:
        rr = E.CSVSequenceRecordReader().initialize(
            E.FileSplit(str(tmp_path), allowed_extensions=["csv"]))
        it = mod.SequenceRecordReaderDataSetIterator(
            rr, 2, label_index=2, num_classes=classes, align=align, **dev)
        got.append(_drain(it, E is JE))
        assert it.batch() == 2
    _same_batches(got[1], got[0])
    x, y, fm, lm = got[1][0]
    assert x.shape == (2, 2, 3)
    np.testing.assert_array_equal(fm, [[1, 1, 1], [1, 1, 0]]
                                  if align == "ALIGN_START"
                                  else [[1, 1, 1], [0, 1, 1]])
    with pytest.raises(ValueError, match="ALIGN_START or ALIGN_END"):
        trec.SequenceRecordReaderDataSetIterator(rr, 2, align="MIDDLE",
                                                 device="cpu")


def test_record_iterators_default_to_the_card():
    rr = TE.CollectionRecordReader([[1.0, 0]]).initialize()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default succeeds")
    for cls in (trec.RecordReaderDataSetIterator,
                trec.SequenceRecordReaderDataSetIterator):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(rr, 2)
    it = trec.RecordReaderDataSetIterator(rr, 2, device="cpu")
    assert it.next().features.torch().device.type == "cpu"


def test_record_iterator_slices_one_device_matrix():
    rr = TE.CollectionRecordReader([[float(i), float(i % 3)]
                                    for i in range(7)]).initialize()
    it = trec.RecordReaderDataSetIterator(rr, 3, label_index=1,
                                          num_classes=3, device="cpu")
    batches = []
    while it.has_next():
        batches.append(it.next())
    assert [b.features.shape[0] for b in batches] == [3, 3, 1]
    base = it._features.untyped_storage().data_ptr()
    assert all(b.features.torch().untyped_storage().data_ptr() == base
               for b in batches)


# -- the whole path ------------------------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _pair(jconf):
    jnet = JMLN(jconf).init()
    tnet = TMLN(TConf.from_json(jconf.to_json()), device="cpu")
    bridge.load_multilayer(tnet, _np_tree(jnet._params),
                           _np_tree(jnet._updater_state), jnet._iteration)
    return jnet, tnet


def _close_params(tnet, jnet):
    for i, (g, r) in enumerate(zip(tnet._params, _np_tree(jnet._params))):
        assert sorted(g) == sorted(r)
        for k in g:
            np.testing.assert_allclose(g[k].detach().numpy(), r[k],
                                       atol=ADAM_ATOL, err_msg=f"{i} {k}")


def _tabular_csv(path, rows=48, seed=0):
    rs = np.random.RandomState(seed)
    with open(path, "w") as f:
        f.write("a,b,c,city,label\n")
        for _ in range(rows):
            a, b, c = rs.randn(3)
            f.write(f"{a:.6f},{b:.6f},{c * 10:.6f},"
                    f"{['SF', 'LA', 'NYC'][rs.randint(3)]},{rs.randint(3)}\n")


def _tabular_iterator(E, mod, dev, path):
    schema = (E.Schema.Builder().add_columns_double("a", "b", "c")
              .add_column_categorical("city", ["SF", "LA", "NYC"])
              .add_column_integer("label").build())
    rr = E.CSVRecordReader(skip_num_lines=1).initialize(E.FileSplit(path))
    records = list(rr)
    stats = E.analyze_local(
        schema, E.LocalTransformExecutor.execute(records, (
            E.TransformProcess.Builder(schema).convert_to_double("c")
            .build()))).analysis_for("c")
    tp = (E.TransformProcess.Builder(schema)
          .categorical_to_one_hot("city")
          .filter(E.ColumnCondition("a", E.ConditionOp.GreaterThan, 2.0))
          .double_math_function("b", "ABS")
          .double_math_op("c", "Subtract", stats.min)
          .double_math_op("c", "Divide", stats.max - stats.min)
          .build())
    return mod.RecordReaderDataSetIterator(
        E.CollectionRecordReader(records).initialize(), 8, label_index=-1,
        num_classes=3, transform_process=tp, **dev)


def test_csv_through_a_transform_process_fits_an_mlp_as_jax(tmp_path):
    path = str(tmp_path / "tab.csv")
    _tabular_csv(path)
    conf = (JNNC.builder().seed(3).updater(jlearn.Adam(1e-3)).list()
            .layer(JL.DenseLayer(n_out=16, activation="relu"))
            .layer(JL.OutputLayer(n_out=3))
            .set_input_type(JInputType.feed_forward(6)).build())
    jnet, tnet = _pair(conf)
    jit_ = _tabular_iterator(JE, jrec, {}, path)
    tit = _tabular_iterator(TE, trec, {"device": "cpu"}, path)
    _same_batches(_drain(tit, False), _drain(jit_, True))
    jnet.fit(jit_, num_epochs=2)
    tnet.fit(tit, num_epochs=2)
    assert tnet._iteration == jnet._iteration == 2 * -(-tit.total_examples()
                                                       // 8)
    _close_params(tnet, jnet)
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value),
                               rtol=LOSS_RTOL)


def test_native_ring_fits_a_lenet_shaped_network_as_jax():
    if not (tnative.available() and jnative.available()):
        pytest.skip("g++ cannot build the native library")
    conf = (JNNC.builder().seed(5).updater(jlearn.Adam(1e-3)).list()
            .layer(JL.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                       activation="relu"))
            .layer(JL.SubsamplingLayer(kernel_size=(2, 2)))
            .layer(JL.DenseLayer(n_out=16, activation="relu"))
            .layer(JL.OutputLayer(n_out=10))
            .set_input_type(JInputType.convolutional(12, 12, 1)).build())
    jnet, tnet = _pair(conf)
    rs = np.random.RandomState(1)
    x = rs.rand(24, 1, 12, 12).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 24)]
    jit_ = jiters.NativeBatchDataSetIterator(x, y, 8, seed=11)
    tit = titers.NativeBatchDataSetIterator(x, y, 8, seed=11, device="cpu")
    jnet.fit(jit_, num_epochs=1)
    tnet.fit(tit, num_epochs=1)
    assert tnet._iteration == jnet._iteration == 3
    _close_params(tnet, jnet)
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value),
                               rtol=LOSS_RTOL)
    assert tit.blocked_s >= 0.0
    tit.close()
    jit_.close()
