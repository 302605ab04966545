"""The port's DL4J ModelSerializer reader (``zoo/dl4j_import.py``) and
``omnihub/`` against the JAX package's, on the CPU and the same bytes.

- Zips in the Java wire format (``tests/test_dl4j_import.py``'s writer,
  ``torch_keras_cases.write_nd4j_array``): the arrays read equal the JAX
  reader's; the MLP and conv zips restore to the JAX restore's params bit
  for bit and its outputs within ``PORT_VS_JAX``.
- The zoo's LeNet as a DL4J zip (``write_dl4j_lenet_zip``) restores
  through ``init_pretrained(path=...)`` to the params written; its
  outputs equal the JAX package's own LeNet run on the JAX restore's
  params. The JAX restore itself ignores DL4J's ``inputPreProcessors``,
  so its LeNet cannot run (reference fault 11, kept as it is there and
  pinned here); the port applies them.
- OmniHub resolves cache-first (a missing file with no fetcher, a
  checksum mismatch and the fetcher hook as the JAX hub) and loads every
  ``kind`` on the CPU, each against the JAX hub's load of the same file.
"""
import hashlib
import io
import json
import zipfile

import h5py
import numpy as np
import pytest

from deeplearning4j_tpu.omnihub import OmniHub as JOmniHub
from deeplearning4j_tpu.zoo import LeNet as JLeNet
from deeplearning4j_tpu.zoo import dl4j_import as jdl
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.omnihub import OmniHub
from deeplearning4j_tpu_torch.zoo import LeNet
from deeplearning4j_tpu_torch.zoo import dl4j_import as tdl

import torch_import_cases as cases
import torch_keras_cases as kc

PORT_VS_JAX = dict(atol=1e-5, rtol=1e-5)


def _zip(path, confs, coefficients, pre=None):
    conf = {"confs": confs}
    if pre is not None:
        conf["inputPreProcessors"] = pre
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("configuration.json", json.dumps(conf))
        z.writestr("coefficients.bin", kc.write_nd4j_array(coefficients))
    return str(path)


def _act(name):
    return {"@class": f"org.nd4j.linalg.activations.impl.{name}"}


def _mlp_zip(path, rs):
    w1, b1 = rs.randn(6, 8).astype(np.float32), rs.randn(8).astype(
        np.float32)
    w2, b2 = rs.randn(8, 3).astype(np.float32), rs.randn(3).astype(
        np.float32)
    confs = [kc._layer("DenseLayer", nIn=6, nOut=8,
                       activationFn=_act("ActivationTanh")),
             kc._layer("OutputLayer", nIn=8, nOut=3,
                       activationFn=_act("ActivationSoftmax"),
                       lossFn={"@class": "org.nd4j.linalg.lossfunctions."
                               "impl.LossMCXENT"})]
    return _zip(path, confs, np.concatenate(
        [w1.ravel(order="F"), b1, w2.ravel(order="F"), b2]))


def _conv_zip(path, rs):
    wc, bc = rs.randn(4, 2, 3, 3).astype(np.float32), rs.randn(4).astype(
        np.float32)
    confs = [kc._layer("ConvolutionLayer", nIn=2, nOut=4, kernelSize=[3, 3],
                       stride=[1, 1], padding=[1, 1],
                       activationFn=_act("ActivationReLU")),
             kc._layer("SubsamplingLayer", poolingType="MAX",
                       kernelSize=[2, 2], stride=[2, 2], padding=[0, 0]),
             kc._layer("BatchNormalization", nOut=4, eps=1e-5, decay=0.9)]
    bn = np.concatenate([1 + 0.1 * rs.randn(4), 0.1 * rs.randn(4),
                         0.1 * rs.randn(4), rs.rand(4) + 0.5])
    return _zip(path, confs, np.concatenate([wc.ravel(order="F"), bc, bn]))


@pytest.mark.parametrize("shape", [(3, 4), (5,), (2, 3, 4, 5)])
def test_read_nd4j_array_equals_jax(shape):
    a = np.random.RandomState(0).randn(*shape).astype(np.float32)
    data = kc.write_nd4j_array(a)
    ours = tdl.read_nd4j_array(io.BytesIO(data))
    theirs = jdl.read_nd4j_array(io.BytesIO(data))
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, a)


@pytest.mark.parametrize("make,x", [
    (_mlp_zip, np.random.RandomState(1).randn(4, 6).astype(np.float32)),
    (_conv_zip,
     np.random.RandomState(1).randn(2, 2, 8, 8).astype(np.float32))],
    ids=["mlp", "conv_bn"])
def test_restore_equals_the_jax_restore(tmp_path, make, x):
    path = make(tmp_path / "m.zip", np.random.RandomState(0))
    ours = tdl.restore_multi_layer_network(path, device="cpu")
    theirs = jdl.restore_multi_layer_network(path)
    assert len(ours._params) == len(theirs._params)
    for p, q in zip(ours._params, theirs._params):
        assert sorted(p) == sorted(q)
        for k in q:
            assert np.array_equal(p[k].numpy(), np.asarray(q[k])), k
    np.testing.assert_allclose(ours.output(x).numpy(),
                               np.asarray(theirs.output(x).numpy()),
                               **PORT_VS_JAX)


def test_lenet_zip_restores_through_init_pretrained(tmp_path):
    path = str(tmp_path / "lenet.zip")
    want = kc.write_dl4j_lenet_zip(path, seed=5)
    net = LeNet().init_pretrained(path=path, device="cpu")
    for i, p in enumerate(want):
        assert sorted(net._params[i]) == sorted(p)
        for k, v in p.items():
            assert np.array_equal(net._params[i][k].numpy(), v), (i, k)
    x = kc.lenet_batch()
    theirs = jdl.restore_multi_layer_network(path)
    # reference fault 11: the JAX reader drops inputPreProcessors, so the
    # dense head meets the conv activations unflattened
    with pytest.raises(TypeError, match="contracting dimensions"):
        theirs.output(x)
    jlenet = JLeNet().init_model()
    jlenet.init(params=theirs._params)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jlenet.output(x).numpy()),
                               **PORT_VS_JAX)


def test_convert_layer_and_refusals_as_jax():
    specs = [
        kc._layer("DenseLayer", nIn=3, nOut=2,
                  activationFn=_act("ActivationSigmoid"))["layer"],
        kc._layer("ConvolutionLayer", nIn=1, nOut=2, kernelSize=[3, 3],
                  convolutionMode="Same")["layer"],
        kc._layer("SubsamplingLayer", poolingType="AVG",
                  kernelSize=[2, 2])["layer"],
        kc._layer("BatchNormalization", nOut=4)["layer"],
        kc._layer("ActivationLayer",
                  activationFn=_act("ActivationELU"))["layer"],
        kc._layer("GlobalPoolingLayer", poolingType="AVG")["layer"],
        kc._layer("LossLayer", lossFn={"@class": "x.LossMSE"})["layer"],
        kc._layer("DropoutLayer")["layer"],
    ]
    for spec in specs:
        (ours, ospec), (theirs, jspec) = tdl.convert_layer(spec), \
            jdl.convert_layer(spec)
        assert type(ours).__name__ == type(theirs).__name__
        assert [(k, s) for k, s, _ in ospec] == [(k, s) for k, s, _ in jspec]
        for f in ("n_in", "n_out", "activation", "kernel_size", "stride",
                  "padding", "pooling_type", "loss"):
            assert getattr(ours, f, None) == getattr(theirs, f, None), f
    for mod in (tdl, jdl):
        with pytest.raises(ValueError, match="unsupported DL4J layer"):
            mod.convert_layer(kc._layer("Yolo2OutputLayer")["layer"])
        with pytest.raises(ValueError, match="unsupported DL4J activation"):
            mod.convert_layer(kc._layer(
                "DenseLayer", activationFn=_act("ActivationFoo"))["layer"])
    for name in ("Foo", "FeedForwardToRnnPreProcessor"):
        with pytest.raises(ValueError, match="unsupported DL4J input "
                                             f"preprocessor '{name}'"):
            tdl.convert_preprocessors({"1": {"@class": f"a.b.{name}"}})


# ---------------------------------------------------------------------------
# OmniHub
# ---------------------------------------------------------------------------

def _keras_sequential_h5(path):
    """A Keras-layout Sequential h5 (model_config + model_weights), written
    with h5py: Dense(4 -> 3, relu)."""
    rs = np.random.RandomState(0)
    cfg = {"class_name": "Sequential", "config": {"name": "s", "layers": [
        {"class_name": "InputLayer", "config": {"batch_shape": [None, 4],
                                                "name": "in"}},
        {"class_name": "Dense", "config": {"name": "d", "units": 3,
                                           "activation": "relu"}}]}}
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(cfg)
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array([b"d"])
        g = mw.create_group("d")
        g.attrs["weight_names"] = np.array([b"d/kernel", b"d/bias"])
        g.create_dataset("d/kernel", data=rs.randn(4, 3).astype(np.float32))
        g.create_dataset("d/bias", data=rs.randn(3).astype(np.float32))
    return path


def _hub_files(d):
    """kind -> (file name, kwargs, input): one artifact of each kind."""
    kc.write_dl4j_lenet_zip(str(d / "lenet.zip"), seed=1)
    sd = SameDiff.create(device="cpu")
    sd.nn.relu(sd.placeholder("x", (None, 3)) @ sd.var(
        "w", np.random.RandomState(2).randn(3, 2).astype(np.float32)))
    sd.save(str(d / "sd.zip"))
    (d / "tiny.pb").write_bytes(cases.bert_graph("tiny", seed=0))
    data, _ = cases.onnx_mlp(np.random.RandomState(0))
    (d / "mlp.onnx").write_bytes(data)
    _keras_sequential_h5(str(d / "seq.h5"))
    feeds = cases.bert_feeds("tiny", 2, 1)
    return {
        "dl4j": ("lenet.zip", {}, kc.lenet_batch(b=2)),
        "samediff": ("sd.zip", {}, None),
        "tf": ("tiny.pb", {"input_shapes": {k: v.shape for k, v in
                                            feeds.items()},
                           "outputs": list(cases.OUTPUTS)}, feeds),
        "onnx": ("mlp.onnx", {}, {"x": np.ones((4, 8), np.float32)}),
        "keras": ("seq.h5", {}, np.random.RandomState(1).randn(
            2, 4).astype(np.float32)),
    }


@pytest.fixture(scope="module")
def hub_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("omnihub")
    return d, _hub_files(d)


@pytest.mark.parametrize("kind", ["dl4j", "samediff", "tf", "onnx",
                                  "keras"])
def test_omnihub_loads_every_kind_on_the_cpu(hub_dir, kind):
    d, files = hub_dir
    fname, kwargs, x = files[kind]
    with open(d / fname, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    ours = OmniHub(str(d)).register("m", kind, fname, digest)
    theirs = JOmniHub(str(d)).register("m", kind, fname, digest)
    assert ours.models() == theirs.models() == ["m"]
    assert ours.path("m") == theirs.path("m")
    got = ours.load("m", device="cpu", **kwargs)
    ref = theirs.load("m", **kwargs)
    if kind == "dl4j":
        # the JAX restore cannot run a LeNet (reference fault 11): its
        # params against the port's, the port's output against
        # init_pretrained's (held to the JAX LeNet above)
        for p, q in zip(got._params, ref._params):
            for k in q:
                assert np.array_equal(p[k].numpy(), np.asarray(q[k]))
        direct = LeNet().init_pretrained(path=str(d / fname), device="cpu")
        assert np.array_equal(got.output(x).numpy(),
                              direct.output(x).numpy())
    elif kind == "keras":
        np.testing.assert_allclose(got.output(x).numpy(),
                                   np.asarray(ref.output(x).numpy()),
                                   **PORT_VS_JAX)
        assert next(iter(got._params[0].values())).device.type == "cpu"
    elif kind == "samediff":
        assert sorted(got._arrays) == sorted(ref._arrays)
        for k in ref._arrays:
            assert np.array_equal(got._arrays[k].numpy(),
                                  np.asarray(ref._arrays[k]))
    else:
        outs = list(cases.OUTPUTS) if kind == "tf" else ["y"]
        a, b = got.output(x, outs), ref.output(x, outs)
        for o in outs:
            np.testing.assert_allclose(a[o].numpy(), np.asarray(
                b[o].numpy()), atol=2e-5)


def test_omnihub_resolution_is_cache_first_as_jax(tmp_path):
    for hub_cls in (OmniHub, JOmniHub):
        hub = hub_cls(str(tmp_path)).register("m", "dl4j", "m.zip",
                                              sha256="0" * 64)
        with pytest.raises(FileNotFoundError, match="no fetcher"):
            hub.path("m")
        fetched = []

        def fetcher(name, filename):
            fetched.append((name, filename))
            p = tmp_path / "elsewhere.zip"
            p.write_bytes(b"zip")
            return str(p)

        hub.fetcher = fetcher
        with pytest.raises(ValueError, match="checksum mismatch"):
            hub.path("m")
        assert fetched == [("m", "m.zip")]
        with pytest.raises(ValueError, match="unknown artifact kind"):
            hub_cls(str(tmp_path)).register(
                "z", "zzz", "elsewhere.zip").load("z")
