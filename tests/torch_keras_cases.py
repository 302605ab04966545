"""Fixtures of the Keras h5, TFLite and DL4J-zip paths, shared by the
port's tests and ``chip_smoke.py``.

Committed under ``tests/torch_data/`` (about 1 MB in all), remade by
:func:`make_fixtures` on a machine with TensorFlow, Keras and h5py:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_keras_cases.py``.

- ``resnet50v2_skeleton.h5``: Keras's own h5 of
  ``keras.applications.ResNet50V2(weights=None)`` (25.6 M parameters),
  copied with h5py so that no weight dataset is written: every group,
  attribute and dataset shape is kept, and each dataset's storage is left
  unallocated. :func:`fill_skeleton` (numpy and the port's HDF5 reader
  only) fills a copy from a seed: it appends each dataset's bytes, points
  the dataset's layout at them and moves the superblock's end-of-file
  address, so the result is an ordinary HDF5 file.
- ``resnet50v2_golden.npz``: Keras's ``predict`` of the *filled* file on
  :func:`resnet_batch`, loaded in Keras, so it holds the filler and the
  importer to Keras at once.
- ``keras_tiny_cnn.h5`` and ``keras_tiny_golden.npz``: a tiny Sequential
  CNN (conv, batch norm, pool, flatten, dense) saved by Keras with its
  weights, and its ``predict`` on :func:`keras_tiny_input`.
- ``tflite_{mlp,cnn}.tflite`` and ``tflite_golden.npz``: the MLP and CNN of
  ``tests/test_tflite.py``, converted by TF's converter, with TF's own
  Interpreter's outputs on a seeded batch.

:func:`write_dl4j_lenet_zip` writes the zoo's LeNet as a DL4J
ModelSerializer zip (the Java wire format) from a seed, numpy only.

Nothing here imports TensorFlow, Keras or h5py at module level; only
:func:`make_fixtures` does, inside itself.
"""
from __future__ import annotations

import io
import json
import os
import struct
import zipfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "torch_data")
SKELETON = os.path.join(DATA, "resnet50v2_skeleton.h5")
GOLDEN = os.path.join(DATA, "resnet50v2_golden.npz")
TFLITE = {name: os.path.join(DATA, f"tflite_{name}.tflite")
          for name in ("mlp", "cnn")}
TFLITE_GOLDEN = os.path.join(DATA, "tflite_golden.npz")
KERAS_TINY = os.path.join(DATA, "keras_tiny_cnn.h5")
KERAS_TINY_GOLDEN = os.path.join(DATA, "keras_tiny_golden.npz")

#: the filler's seed and the golden batch's, B=8 at 224 x 224 (NHWC)
RESNET_SEED, RESNET_BATCH_SEED, RESNET_B = 0, 1, 8
RESNET50V2_PARAMS = 25_613_800
#: the tolerance of tests/test_keras_applications.py for this model
RESNET_ATOL, RESNET_RTOL = 1e-4, 1e-4


# ---------------------------------------------------------------------------
# the skeleton's filler (numpy and the port's HDF5 reader only)
# ---------------------------------------------------------------------------

#: the scale of a residual branch's last convolution (``*_3_conv``)
#: against He's: at full He scale each block doubles the residual stream
#: (the batch norms hold fixed moving statistics) and the softmax
#: saturates to one class; at a fifth its top-1 is about 0.28 and its
#: top-2 margin about 0.21
BRANCH_SCALE = 0.2


def _draw(path: str, shape, rs: np.random.RandomState) -> np.ndarray:
    """One weight by its Keras name: kernels at He scale (a residual
    branch's last at :data:`BRANCH_SCALE` of it), ``gamma`` near 1,
    ``moving_variance`` positive, the rest small."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        scale = BRANCH_SCALE if path.endswith("_3_conv/kernel") else 1.0
        return rs.standard_normal(shape) * (scale * np.sqrt(2.0 / fan_in))
    if leaf == "gamma":
        return 1.0 + 0.1 * rs.standard_normal(shape)
    if leaf == "moving_variance":
        return rs.uniform(0.5, 1.5, shape)
    return 0.1 * rs.standard_normal(shape)


def fill_skeleton(skeleton=SKELETON, seed: int = RESNET_SEED) -> bytes:
    """The skeleton's bytes with every unallocated dataset drawn from
    ``seed`` (in ``visititems`` order) and appended, 8-byte aligned."""
    from deeplearning4j_tpu_torch.modelimport import h5
    with open(skeleton, "rb") as f:
        data = bytearray(f.read())
    f = h5.File(bytes(data))
    rs = np.random.RandomState(seed)
    for ds in f.datasets():
        if ds.layout != "contiguous" or ds.data_address is not None:
            continue
        arr = _draw(ds.name, ds.shape, rs).astype(ds.dtype.newbyteorder("<"))
        data += bytes(-len(data) % 8)
        struct.pack_into("<Q", data, ds.address_field, len(data) - f.base)
        data += arr.tobytes()
    struct.pack_into("<Q", data, f.eof_field, len(data) - f.base)
    return bytes(data)


def write_filled(path: str, seed: int = RESNET_SEED) -> str:
    with open(path, "wb") as f:
        f.write(fill_skeleton(seed=seed))
    return path


def resnet_batch(seed: int = RESNET_BATCH_SEED, b: int = RESNET_B
                 ) -> np.ndarray:
    """The golden's input, NHWC in [0, 1) (tests/test_keras_applications'
    ResNet50V2 input, at B=8)."""
    return np.random.RandomState(seed).rand(b, 224, 224, 3).astype(
        np.float32)


def check_against_golden(res: np.ndarray, golden: np.ndarray,
                         atol: float = RESNET_ATOL,
                         rtol: float = RESNET_RTOL) -> bool:
    """tests/test_keras_applications.py's rule, row by row: allclose at
    (atol, rtol), and the argmax agrees where the golden's top-2 margin
    clears twice the tolerance. True when every row's argmax was held."""
    np.testing.assert_allclose(res, golden, atol=atol, rtol=rtol)
    held = True
    for r, g in zip(res.reshape(len(res), -1), golden.reshape(
            len(golden), -1)):
        top2 = np.sort(g)[-2:]
        if top2[1] - top2[0] > 2 * atol:
            assert r.argmax() == g.argmax()
        else:
            held = False
    return held


def keras_tiny_input() -> np.ndarray:
    """The tiny CNN's golden input, NHWC."""
    return np.random.RandomState(4).randn(4, 8, 8, 3).astype(np.float32)


def keras_tiny_golden() -> np.ndarray:
    with np.load(KERAS_TINY_GOLDEN) as z:
        return z["golden"]


# ---------------------------------------------------------------------------
# DL4J ModelSerializer zips (the Java wire format)
# ---------------------------------------------------------------------------

def _write_utf(buf, s):
    buf.write(struct.pack(">H", len(s)))
    buf.write(s.encode())


def write_nd4j_array(arr: np.ndarray) -> bytes:
    """Nd4j.write bytes: a shapeInfo LONG buffer, then a FLOAT data
    buffer (big-endian, 'f' order), as tests/test_dl4j_import.py's."""
    buf = io.BytesIO()
    rank = arr.ndim
    shape_info = ([rank] + list(arr.shape) + [0] * rank + [0, 1, ord("f")])
    _write_utf(buf, "HEAP")
    buf.write(struct.pack(">q", len(shape_info)))
    _write_utf(buf, "LONG")
    for v in shape_info:
        buf.write(struct.pack(">q", int(v)))
    flat = np.asarray(arr, np.float32).ravel(order="F")
    _write_utf(buf, "HEAP")
    buf.write(struct.pack(">q", flat.size))
    _write_utf(buf, "FLOAT")
    buf.write(flat.astype(">f4").tobytes())
    return buf.getvalue()


def _act(name):
    return {"@class": f"org.nd4j.linalg.activations.impl.{name}"}


def _layer(kind, **fields):
    return {"layer": {"@class": f"org.deeplearning4j.nn.conf.layers.{kind}",
                      **fields}}


def write_dl4j_lenet_zip(path: str, seed: int = 0, classes: int = 10):
    """The zoo's LeNet (1x28x28: conv 5x5x20, max 2x2, conv 5x5x50,
    max 2x2, dense 500, softmax) as a DL4J ModelSerializer zip, its
    weights drawn from ``seed`` (He scale). Returns the params in the
    port's layout (HWIO kernels), for the tests to hold a restore
    against."""
    rs = np.random.RandomState(seed)

    def he(shape, fan_in):
        return (rs.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(
            np.float32)

    w1 = he((20, 1, 5, 5), 25)
    b1 = (0.1 * rs.standard_normal(20)).astype(np.float32)
    w2 = he((50, 20, 5, 5), 500)
    b2 = (0.1 * rs.standard_normal(50)).astype(np.float32)
    w3 = he((800, 500), 800)
    b3 = (0.1 * rs.standard_normal(500)).astype(np.float32)
    w4 = he((500, classes), 500)
    b4 = (0.1 * rs.standard_normal(classes)).astype(np.float32)
    conv = dict(kernelSize=[5, 5], stride=[1, 1], padding=[0, 0],
                convolutionMode="Truncate",
                activationFn=_act("ActivationReLU"))
    pool = dict(poolingType="MAX", kernelSize=[2, 2], stride=[2, 2],
                padding=[0, 0])
    confs = [
        _layer("ConvolutionLayer", nIn=1, nOut=20, **conv),
        _layer("SubsamplingLayer", **pool),
        _layer("ConvolutionLayer", nIn=20, nOut=50, **conv),
        _layer("SubsamplingLayer", **pool),
        _layer("DenseLayer", nIn=800, nOut=500,
               activationFn=_act("ActivationReLU")),
        _layer("OutputLayer", nIn=500, nOut=classes,
               activationFn=_act("ActivationSoftmax"),
               lossFn={"@class":
                       "org.nd4j.linalg.lossfunctions.impl.LossMCXENT"}),
    ]
    # DL4J flattening: per layer in order, each view in 'f' order
    coeff = np.concatenate([a.ravel(order="F") for a in
                            (w1, b1, w2, b2, w3, b3, w4, b4)])
    # DL4J writes the flatten before the dense head as a preprocessor
    pre = {"4": {"@class": "org.deeplearning4j.nn.conf.preprocessor."
                 "CnnToFeedForwardPreProcessor",
                 "inputHeight": 4, "inputWidth": 4, "numChannels": 50}}
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("configuration.json", json.dumps(
            {"confs": confs, "inputPreProcessors": pre}))
        z.writestr("coefficients.bin", write_nd4j_array(coeff))
    hwio = (2, 3, 1, 0)
    return [{"W": w1.transpose(hwio), "b": b1}, {},
            {"W": w2.transpose(hwio), "b": b2}, {},
            {"W": w3, "b": b3}, {"W": w4, "b": b4}]


def lenet_batch(seed: int = 2, b: int = 16) -> np.ndarray:
    return np.random.RandomState(seed).rand(b, 1, 28, 28).astype(np.float32)


# ---------------------------------------------------------------------------
# TFLite
# ---------------------------------------------------------------------------

def tflite_inputs():
    """The seeded inputs the TFLite goldens were taken on (the MLP's and
    the CNN's of tests/test_tflite.py)."""
    return {"mlp": np.random.RandomState(0).randn(3, 12).astype(np.float32),
            "cnn": np.random.RandomState(1).randn(2, 16, 16, 3).astype(
                np.float32)}


def tflite_goldens():
    with np.load(TFLITE_GOLDEN) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the fixtures' maker (TensorFlow, Keras and h5py, imported here only)
# ---------------------------------------------------------------------------

def _copy_skeleton(src: str, dst: str):
    """Keras's h5 copied group by group with h5py, each dataset created
    with its shape and dtype and never written (storage unallocated)."""
    import h5py

    def copy_attrs(s, d):
        for k in s.attrs:
            d.attrs.create(k, s.attrs[k], dtype=s.attrs.get_id(k).dtype)

    with h5py.File(src, "r") as s, h5py.File(dst, "w") as d:
        copy_attrs(s, d)

        def walk(sg, dg):
            for k in sg.keys():
                obj = sg[k]
                if isinstance(obj, h5py.Dataset):
                    ds = dg.create_dataset(k, shape=obj.shape,
                                           dtype=obj.dtype)
                else:
                    ds = dg.create_group(k)
                    walk(obj, ds)
                copy_attrs(obj, ds)

        walk(s, d)


def _interpret(flat: bytes, x: np.ndarray) -> np.ndarray:
    import tensorflow as tf
    it = tf.lite.Interpreter(model_content=flat)
    d = it.get_input_details()[0]
    it.resize_tensor_input(d["index"], x.shape)
    it.allocate_tensors()
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    return it.get_tensor(it.get_output_details()[0]["index"])


def tflite_models():
    """The MLP and CNN of tests/test_tflite.py (tf.keras)."""
    import tensorflow as tf
    L = tf.keras.layers
    mlp = tf.keras.Sequential([tf.keras.Input((12,)),
                               L.Dense(16, activation="relu"),
                               L.Dense(4, activation="softmax")])
    cnn = tf.keras.Sequential([
        tf.keras.Input((16, 16, 3)),
        L.Conv2D(8, 3, padding="same", activation="relu"),
        L.MaxPooling2D(2), L.DepthwiseConv2D(3, padding="valid"),
        L.AveragePooling2D(2), L.Flatten(), L.Dense(5)])
    return {"mlp": mlp, "cnn": cnn}


def make_fixtures(out_dir: str = DATA):
    """Rewrite every file above (TensorFlow, Keras and h5py needed)."""
    import tempfile
    import keras
    import tensorflow as tf
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "resnet50v2.h5")
        keras.utils.set_random_seed(0)
        keras.applications.ResNet50V2(weights=None).save(src)
        skel = os.path.join(out_dir, os.path.basename(SKELETON))
        _copy_skeleton(src, skel)
        filled = os.path.join(td, "filled.h5")
        with open(filled, "wb") as f:
            f.write(fill_skeleton(skel, RESNET_SEED))
        model = keras.models.load_model(filled)
        golden = model.predict(resnet_batch(), verbose=0)
        np.savez(os.path.join(out_dir, os.path.basename(GOLDEN)),
                 golden=golden, seed=RESNET_SEED,
                 batch_seed=RESNET_BATCH_SEED)
    keras.utils.set_random_seed(0)
    L = keras.layers
    tiny = keras.Sequential([
        keras.Input((8, 8, 3)),
        L.Conv2D(4, 3, activation="relu", padding="same", name="c1"),
        L.BatchNormalization(name="bn1"), L.MaxPooling2D(2, name="p1"),
        L.Flatten(name="f"), L.Dense(10, activation="softmax", name="d1")])
    tiny.save(os.path.join(out_dir, os.path.basename(KERAS_TINY)))
    np.savez(os.path.join(out_dir, os.path.basename(KERAS_TINY_GOLDEN)),
             golden=tiny.predict(keras_tiny_input(), verbose=0))
    tf.keras.utils.set_random_seed(0)
    xs, outs = tflite_inputs(), {}
    for name, m in tflite_models().items():
        flat = tf.lite.TFLiteConverter.from_keras_model(m).convert()
        with open(os.path.join(out_dir, os.path.basename(TFLITE[name])),
                  "wb") as f:
            f.write(flat)
        outs[name] = _interpret(flat, xs[name])
    np.savez(os.path.join(out_dir, os.path.basename(TFLITE_GOLDEN)), **outs)


if __name__ == "__main__":
    make_fixtures()
