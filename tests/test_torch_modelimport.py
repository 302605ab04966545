"""The port's model import (``deeplearning4j_tpu_torch/modelimport``,
``interop``) against the JAX package's and TensorFlow, on the CPU.

- The tiny BERT skeleton (``tests/torch_data``), filled from a seed, runs
  through TensorFlow (golden), the JAX import and the port import: both
  within atol 2e-5 of TF (``test_bert_golden``'s tolerance), the port
  within ``PORT_VS_JAX`` (1e-5) of the JAX package, and every static shape
  the JAX import propagated present in the port's, equal.
- ``supported_ops`` and the coverage tables equal the JAX package's.
- ``.fb`` files: each package reads what the other wrote, to the same
  graph and the same output bits (a graph both can write); the two
  writers' bytes are equal there. The imported BERT's ``.fb`` (shape ops
  the port packs beyond the JAX writer) round-trips on the port bit for
  bit.
- No module of the port imports flatbuffers, ml_dtypes, tensorflow, onnx
  or JAX at import time (a fresh interpreter with those blocked).
"""
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
tf1 = tf.compat.v1

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff  # noqa: E402
from deeplearning4j_tpu.interop import GraphRunner as JGraphRunner  # noqa: E402
from deeplearning4j_tpu.interop import OnnxRunner as JOnnxRunner  # noqa: E402
from deeplearning4j_tpu.modelimport import coverage as jcoverage  # noqa: E402
from deeplearning4j_tpu.modelimport import ir as jir  # noqa: E402
from deeplearning4j_tpu.modelimport.samediff_fb import \
    load_samediff_fb as j_load_fb  # noqa: E402
from deeplearning4j_tpu_torch import interop, modelimport  # noqa: E402
from deeplearning4j_tpu_torch.autodiff import serialization  # noqa: E402
from deeplearning4j_tpu_torch.autodiff.samediff import \
    SameDiff as TSameDiff  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import (  # noqa: E402
    coverage, flatbuf, ir, samediff_fb)
from deeplearning4j_tpu_torch.modelimport.onnx.importer import \
    OnnxImporter  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.tf.importer import \
    TFGraphImporter  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.tf.parser import \
    parse_graphdef  # noqa: E402
from deeplearning4j_tpu_torch.omnihub import OmniHub  # noqa: E402
from deeplearning4j_tpu_torch.zoo import dl4j_import  # noqa: E402

import torch_import_cases as cases  # noqa: E402
from torch_import_check import (PORT_VS_JAX, both_tf,  # noqa: E402
                               check_avals)

#: ``tests/test_modelimport.py::test_bert_golden``'s tolerance against TF
TF_GOLDEN = dict(atol=2e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tf_run(pb, feeds, outputs):
    gd = tf1.GraphDef()
    gd.ParseFromString(pb)
    g = tf.Graph()
    with g.as_default():
        tf.import_graph_def(gd, name="")
    with tf1.Session(graph=g) as s:
        return s.run([o + ":0" for o in outputs],
                     {k + ":0": v for k, v in feeds.items()})


@pytest.fixture(scope="module")
def tiny_bert():
    pb = cases.bert_graph("tiny", seed=3)
    feeds = cases.bert_feeds("tiny", batch=2, masked=4)
    shapes = {k: v.shape for k, v in feeds.items()}
    return pb, feeds, shapes


# ---------------------------------------------------------------- BERT
def test_tiny_bert_against_tf_and_jax(tiny_bert):
    pb, feeds, shapes = tiny_bert
    golden = _tf_run(pb, feeds, cases.OUTPUTS)
    imp = both_tf(pb, input_shapes=shapes, outputs=list(cases.OUTPUTS))
    res = imp.output(feeds, list(cases.OUTPUTS))   # port within PORT_VS_JAX
    jres = imp.jax.output(feeds, list(cases.OUTPUTS))
    for name, gold in zip(cases.OUTPUTS, golden):
        np.testing.assert_allclose(res[name].numpy(), gold, **TF_GOLDEN)
        np.testing.assert_allclose(np.asarray(jres[name].numpy()), gold,
                                   **TF_GOLDEN)
    # the tf.shape-driven reshape chains folded: every reshape is static
    reshapes = [n for n in imp.sd._ops.values() if n.op_name == "reshape"]
    assert reshapes and all(all(isinstance(d, int) for d in n.kwargs["shape"])
                            for n in reshapes)
    assert len(imp.ctx._var_aval) == len(imp.jax.ctx._var_aval) > 150


def test_tiny_skeleton_is_what_the_maker_makes():
    assert cases.make_skeleton("tiny") == cases.read_skeleton("tiny")


def test_fill_is_seeded_and_fills_every_stripped_weight():
    sk = cases.read_skeleton("tiny")
    a, b = cases.bert_graph("tiny", seed=1), cases.bert_graph("tiny", seed=1)
    assert a == b != cases.bert_graph("tiny", seed=2)
    empty = parse_graphdef(sk).initializers
    full = parse_graphdef(a).initializers
    assert set(empty) == set(full)
    stripped = [k for k, v in empty.items()
                if v.dtype == np.float32 and v.size > 1 and not v.any()
                and v.nbytes > 1024]
    assert stripped and all(full[k].std() > 0.01 for k in stripped)
    kept = [k for k in empty if k not in stripped]
    assert all(np.array_equal(empty[k], full[k]) for k in kept)


def test_base_skeleton_is_bert_base():
    """The committed full-width skeleton: BERT-base's 110M parameters,
    T=128, under 1 MB with its twin (read without filling)."""
    g = parse_graphdef(cases.read_skeleton("base"))
    n = sum(v.size for v in g.initializers.values()
            if v.dtype == np.float32 and v.ndim >= 1)
    assert n == cases.BERT_BASE_PARAMS == 109_482_240
    assert g.inputs["input_ids:0"] == ((None, 128), "int32")
    assert sum(os.path.getsize(cases.skeleton_path(k))
               for k in cases.BERT) < 1 << 20


def test_mask_feeds():
    f = cases.bert_feeds("tiny", batch=3, masked=5)
    assert f["input_mask"].shape == (3, 16)
    assert (f["input_mask"][:, -5:] == 0).all() and \
        (f["input_mask"][:, :-5] == 1).all()


# ------------------------------------------------------ registry parity
@pytest.mark.parametrize("framework", ["tensorflow", "onnx"])
def test_supported_ops_equal_jax(framework):
    assert ir.supported_ops(framework) == jir.supported_ops(framework)


def test_coverage_tables_equal_jax():
    for name in ("TF_STRUCTURAL", "TF_EXEMPT", "ONNX_STRUCTURAL",
                 "ONNX_EXEMPT"):
        assert getattr(coverage, name) == getattr(jcoverage, name)


def test_unmapped_error_names_exemptions():
    e = ir.unmapped_error("tensorflow", ["Unique", "Bogus"])
    assert str(e) == str(jir.unmapped_error("tensorflow",
                                            ["Unique", "Bogus"]))


def test_run_import_walks_the_ir_as_jax_does():
    """``run_import`` (the IR-level import, no folding or frames) on the
    ONNX MLP's IR: the same graph, the same static shapes, the same
    outputs."""
    from deeplearning4j_tpu.modelimport.onnx.parser import \
        parse_model as j_parse
    from deeplearning4j_tpu_torch.modelimport.onnx.parser import parse_model
    data, _ = cases.onnx_mlp(np.random.RandomState(0))
    jctx = jir.run_import(j_parse(data))
    tctx = ir.run_import(parse_model(data), device="cpu")
    check_avals(jctx, tctx)
    x = np.random.RandomState(1).randn(4, 8).astype(np.float32)
    y = tctx.vars["y"].name
    np.testing.assert_allclose(
        tctx.sd.output({"x": x}, [y])[y].numpy(),
        np.asarray(jctx.sd.output({"x": x}, [y])[y].numpy()), **PORT_VS_JAX)


def test_host_reading_op_has_no_static_shape():
    """An op that reads its data on the host gives no static shape (it
    raises on meta tensors), never one computed from stand-in values;
    an op that does not, gives one."""
    g = ir.IRGraph("tensorflow", [], {}, {}, [])
    ctx = ir.ImportContext(g, device="cpu")
    ctx.bind("x", ctx.sd.placeholder("x", (6,)))
    ctx.emit("histogram", [ctx.get("x")], "h", bins=4)   # float(x.min())
    ctx.emit("exp", [ctx.get("x")], "e")
    assert ctx.aval("h") is None
    assert ctx.aval("e") == ir.Aval((6,), np.dtype(np.float32))


def test_bf16_constants_and_casts():
    bits = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    g = tf.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, [3, 4], name="x")
        c = tf.constant(bits, dtype=tf.bfloat16)
        y = tf.cast(tf.cast(x, tf.bfloat16) * c, tf.float32, name="out")
    pb = g.as_graph_def().SerializeToString()
    xs = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    # the port rounds the bf16 product to bf16 as TF does (bit for bit);
    # XLA's CPU fusion keeps it in f32: two bf16 ulps (rtol 2 ** -7)
    imp = both_tf(pb, tol=dict(atol=0, rtol=2 ** -7),
                  input_shapes={"x": (3, 4)}, outputs=["out"])
    got = imp.output({"x": xs}, ["out"])["out"].numpy()
    np.testing.assert_array_equal(got, _tf_run(pb, {"x": xs}, ["out"])[0])
    consts = [a for a in imp.ctx.const_np.values() if a.dtype.kind == "V"]
    assert consts and consts[0].dtype == ir.BFLOAT16


# ------------------------------------------------------------------ .fb
def _mlp(sd_cls, **kw):
    """``tests/test_samediff_fb_writer.py``'s MLP, recorded the same way
    on either package, with an updater state."""
    sd = sd_cls.create(**kw)
    x = sd.placeholder("input", (None, 8))
    y = sd.placeholder("label", (None, 4))
    rs = np.random.RandomState(0)
    w0 = sd.var("w0", rs.randn(8, 16).astype(np.float32) * 0.3)
    b0 = sd.var("b0", np.zeros((1, 16), np.float32))
    w1 = sd.var("w1", rs.randn(16, 4).astype(np.float32) * 0.3)
    h = sd.invoke("tanh", x.mmul(w0) + b0)
    sm = sd.invoke("softmax", h.mmul(w1), axis=-1)
    red = sd.invoke("reduce_sum", sm, dims=[0], keep_dims=True)
    loss = sd.invoke("reduce_mean", sd.invoke("square", sm - y))
    sd.set_loss_variables(loss)
    state = {k: {p: np.full(s, i + 0.5, np.float32) for p, s in
                 (("w0", (8, 16)), ("b0", (1, 16)), ("w1", (16, 4)))}
             for i, k in enumerate(("m", "v"))}
    if sd_cls is TSameDiff:
        state = {k: {p: torch.from_numpy(a) for p, a in d.items()}
                 for k, d in state.items()}
    sd._updater_state = state
    return sd, [sm.name, red.name, loss.name]


def _feeds():
    rs = np.random.RandomState(7)
    x = rs.randn(4, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 4)]
    return {"input": x, "label": y}


def _structure(sd):
    return ([(n.name, n.op_name, list(n.inputs), list(n.outputs))
             for n in (sd._ops[k] for k in sd._op_order)],
            [(v.name, v.var_type.value, v.shape, v.dtype)
             for v in sd._vars.values()])


def test_fb_files_cross_read_with_the_same_bits(tmp_path):
    jsd, outs = _mlp(JSameDiff)
    tsd, _ = _mlp(TSameDiff, device="cpu")
    jpath, tpath = str(tmp_path / "j.fb"), str(tmp_path / "t.fb")
    jsd.save_flatbuffers(jpath, save_updater_state=True)
    tsd.save_flatbuffers(tpath, save_updater_state=True)
    with open(jpath, "rb") as f1, open(tpath, "rb") as f2:
        assert f1.read() == f2.read()        # the two writers agree
    t_from_j = samediff_fb.load_samediff_fb(jpath, device="cpu")
    j_from_t = j_load_fb(tpath)
    assert _structure(t_from_j) == _structure(j_from_t)
    feeds = _feeds()
    t_ref, j_ref = tsd.output(feeds, outs), jsd.output(feeds, outs)
    t_got, j_got = t_from_j.output(feeds, outs), j_from_t.output(feeds, outs)
    for o in outs:
        assert torch.equal(t_got[o].torch(), t_ref[o].torch())
        assert np.array_equal(np.asarray(j_got[o].numpy()),
                              np.asarray(j_ref[o].numpy()))
        np.testing.assert_allclose(t_got[o].numpy(),
                                   np.asarray(j_got[o].numpy()),
                                   **PORT_VS_JAX)
    assert t_from_j.fb_loss_variables == j_from_t.fb_loss_variables
    for key, d in j_from_t._updater_state.items():
        for p, a in d.items():
            assert np.array_equal(t_from_j._updater_state[key][p].numpy(),
                                  np.asarray(a))


def test_imported_bert_fb_round_trip_bit_for_bit(tiny_bert, tmp_path):
    pb, feeds, shapes = tiny_bert
    imp = modelimport.import_tf_graph(pb, input_shapes=shapes,
                                      outputs=list(cases.OUTPUTS),
                                      device="cpu")
    path = str(tmp_path / "bert.fb")
    imp.sd.save_flatbuffers(path)
    sd2 = samediff_fb.load_samediff_fb(path, device="cpu")
    assert _structure(sd2)[0] == _structure(imp.sd)[0]
    outs = [imp.outputs[o + ":0"] for o in cases.OUTPUTS]
    ph = {imp.inputs[k + ":0"]: v for k, v in feeds.items()}
    a, b = imp.sd.output(ph, outs), sd2.output(ph, outs)
    assert all(torch.equal(a[o].torch(), b[o].torch()) for o in outs)


@pytest.mark.parametrize("spec", [
    [("all",), ("slice", 1, 3, 1)],
    [("int", 0), ("slice", None, -1, 2), ("newaxis",)],
    [("ellipsis",), ("int", -1)],
    [("slice", 2, None, 1), ("all",), ("slice", None, 4, 3)],
])
def test_strided_slice_packing_round_trips(spec):
    packed, _ = serialization._pack_strided_slice({"spec": spec})

    class Node:
        i_args = packed["i_args"]

    _, kw = samediff_fb._conv_strided_slice(Node)
    x = torch.arange(5 * 6 * 7).reshape(5, 6, 7)
    from deeplearning4j_tpu_torch.ops import OpRegistry
    fn = OpRegistry.get().lookup("tf_strided_slice").fn
    assert torch.equal(fn(x, spec=kw["spec"]), fn(x, spec=spec))


def test_save_flatbuffers_refusals(tmp_path):
    sd = TSameDiff.create(device="cpu")
    x = sd.placeholder("x", (2, 3))
    sd.invoke("tile", x, reps=[2, 1])
    with pytest.raises(ValueError, match="no FlatBuffers arg packing"):
        sd.save_flatbuffers(str(tmp_path / "a.fb"))
    sd = TSameDiff.create(device="cpu")
    sd.invoke("random_normal", shape=(2,), needs_key=True)
    with pytest.raises(ValueError, match="RNG"):
        sd.save_flatbuffers(str(tmp_path / "b.fb"))


def test_builder_layout_equals_the_flatbuffers_runtime():
    fb = pytest.importorskip("flatbuffers")

    def build(b):
        rs = np.random.RandomState(0)
        offs = []
        for k in range(6):
            s = b.CreateString("n" * k)
            v = b.CreateNumpyVector(rs.randn(k + 1))
            bv = b.CreateByteVector(bytes(range(2 * k + 1)))
            b.StartVector(1, 2, 1)
            b.PrependBool(True)
            b.PrependBool(k % 2 == 0)
            bb = b.EndVector()
            b.StartObject(12)
            b.PrependInt32Slot(0, k, 0)
            b.PrependUOffsetTRelativeSlot(1, s, 0)
            b.PrependInt8Slot(2, k % 3, 0)
            if k % 2:
                b.PrependUOffsetTRelativeSlot(5, v, 0)
            b.PrependUOffsetTRelativeSlot(6, bv, 0)
            b.PrependUOffsetTRelativeSlot(10, bb, 0)
            offs.append(b.EndObject())
        b.StartVector(4, len(offs), 4)
        for o in reversed(offs):
            b.PrependUOffsetTRelative(o)
        vec = b.EndVector()
        b.StartObject(3)
        b.PrependUOffsetTRelativeSlot(1, vec, 0)
        b.Finish(b.EndObject())
        return bytes(b.Output())

    ours = build(flatbuf.Builder(8))
    assert ours == build(fb.Builder(8))
    root = flatbuf.root(ours)
    assert flatbuf.vec_len(root, 1) == 6
    t = flatbuf.vec_table(root, 1, 3)
    assert (flatbuf.i32(t, 0), flatbuf.string(t, 1), flatbuf.i8(t, 2)) == \
        (3, "nnn", 0)
    assert len(flatbuf.vec_f64(t, 5)) == 4
    assert flatbuf.vec_bytes(t, 6) == bytes(range(7))
    assert flatbuf.vec_bool(t, 10) == [False, True]
    assert flatbuf.subtable(t, 4) is None and flatbuf.vec_len(t, 9) == 0


# ---------------------------------------------------------------- interop
def test_graph_runner_and_onnx_runner_against_jax():
    rs = np.random.RandomState(0)
    g = tf.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, [4, 8], name="x")
        w = tf.constant(rs.randn(8, 3).astype(np.float32))
        tf.nn.softmax(tf.matmul(x, w), name="out")
    pb = g.as_graph_def().SerializeToString()
    xs = rs.randn(4, 8).astype(np.float32)
    native = interop.GraphRunner(pb, ["x"], ["out"], {"x": (4, 8)},
                                 backend="native", device="cpu")
    with interop.GraphRunner(pb, ["x"], ["out"], backend="tensorflow") as r:
        via_tf = r.run({"x": xs})["out"].numpy()
    jr = JGraphRunner(pb, ["x"], ["out"], {"x": (4, 8)}, backend="native")
    got = native.run({"x": xs})["out"].numpy()
    np.testing.assert_allclose(got, np.asarray(jr.run({"x": xs})["out"]
                                               .numpy()), **PORT_VS_JAX)
    np.testing.assert_allclose(got, via_tf, atol=1e-6)
    data, _ = cases.onnx_mlp(np.random.RandomState(1))
    xo = rs.randn(4, 8).astype(np.float32)
    t = interop.OnnxRunner(data, device="cpu").run({"x": xo})["y"].numpy()
    j = JOnnxRunner(data).run({"x": xo})["y"].numpy()
    np.testing.assert_allclose(t, np.asarray(j), **PORT_VS_JAX)


def test_unported_entry_points_name_their_item(tmp_path):
    """The Keras and TFLite entry points (ported since item 11c-ii) fail
    as the JAX package's do on a missing path and on empty bytes: a
    missing h5 is ``FileNotFoundError``, an empty one ``OSError`` (h5py's
    "file signature not found"), an empty or missing .tflite
    ``ValueError`` / ``FileNotFoundError``."""
    from deeplearning4j_tpu import interop as jinterop
    from deeplearning4j_tpu import modelimport as jmodelimport
    empty = tmp_path / "empty.h5"
    empty.write_bytes(b"")
    missing = str(tmp_path / "m.h5")
    for mi, kw in ((modelimport, {"device": "cpu"}), (jmodelimport, {})):
        for entry in (mi.import_keras_model_and_weights,
                      mi.KerasModelImport
                      .import_keras_sequential_model_and_weights):
            with pytest.raises(FileNotFoundError):
                entry(missing, **kw)
            with pytest.raises(OSError, match="signature not found"):
                entry(str(empty), **kw)
    for runner, kw in ((interop.TfliteRunner, {"device": "cpu"}),
                       (jinterop.TfliteRunner, {})):
        with pytest.raises(ValueError, match="not a parseable .tflite"):
            runner(b"", **kw)
        with pytest.raises(FileNotFoundError):
            runner(str(tmp_path / "m.tflite"), **kw)


ENTRY_POINTS = [modelimport.import_tf_graph, modelimport.import_onnx_model,
                TFGraphImporter.__init__, OnnxImporter.__init__,
                samediff_fb.load_samediff_fb,
                samediff_fb.SameDiffFbImport.__init__,
                ir.ImportContext.__init__, ir.run_import,
                interop.GraphRunner.__init__, interop.OnnxRunner.__init__,
                modelimport.import_keras_model_and_weights,
                modelimport.import_keras_sequential_model_and_weights,
                modelimport.KerasModelImport.import_keras_model_and_weights,
                modelimport.KerasModelImport
                .import_keras_sequential_model_and_weights,
                interop.TfliteRunner.__init__,
                dl4j_import.restore_multi_layer_network, OmniHub.load]


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_entry_point_defaults_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_no_third_party_import_at_import_time():
    """A fresh interpreter in which flatbuffers, ml_dtypes, tensorflow,
    onnx, h5py, keras, JAX and the JAX package cannot be imported loads
    every module of the import slices (``modelimport``, ``interop``,
    ``zoo``, ``omnihub``, ``ui``, ``analysis``), imports, writes and reads
    a graph on the CPU, and imports the Keras ResNet50V2 skeleton."""
    code = r'''
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("flatbuffers", "ml_dtypes", "tensorflow", "onnx", "h5py",
           "keras", "jax", "jaxlib", "deeplearning4j_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import deeplearning4j_tpu_torch.modelimport as mi
import deeplearning4j_tpu_torch.interop as io
import deeplearning4j_tpu_torch.zoo as zoo
import deeplearning4j_tpu_torch.omnihub as hub
import deeplearning4j_tpu_torch.ui as ui
import deeplearning4j_tpu_torch.analysis as an
for pkg in (mi, io, zoo, hub, ui, an):
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
import numpy as np, tempfile, os
sys.path.insert(0, "tests")
import torch_import_cases as cases
data, _ = cases.onnx_mlp(np.random.RandomState(0))
imp = mi.import_onnx_model(data, device="cpu")
y = imp.output({"x": np.ones((4, 8), np.float32)}, ["y"])["y"].numpy()
path = os.path.join(tempfile.mkdtemp(), "g.fb")
imp.sd.save_flatbuffers(path)
from deeplearning4j_tpu_torch.modelimport.samediff_fb import load_samediff_fb
sd = load_samediff_fb(path, device="cpu")
out = imp.outputs["y"]
assert np.array_equal(sd.output({"x": np.ones((4, 8), np.float32)},
                                [out])[out].numpy(), y)
import torch_keras_cases as kc
net = mi.import_keras_model_and_weights(kc.SKELETON, device="cpu")
assert len(net.conf.vertices) == 191
print("ok")
'''
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
