"""The port's TFLite runner (``interop/tflite.py``) against the JAX
package's runner and TF's own Interpreter, on the CPU and the same bytes.

The cases of ``tests/test_tflite.py``: each ``.tflite`` runs through TF's
Interpreter (golden), the JAX runner and the port's runner on the CPU.
The port within ``PORT_VS_JAX`` of the JAX runner and within each JAX
test's own tolerance of the Interpreter. The MLP and CNN are the committed
files (``tests/torch_data``), held to their committed Interpreter goldens
too; the other cases are converted once, in a module fixture. Quantized
and dynamic-range models are refused by both runners alike.
"""
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from deeplearning4j_tpu.interop import TfliteRunner as JTfliteRunner  # noqa: E402,E501
from deeplearning4j_tpu_torch.interop import TfliteRunner  # noqa: E402

import torch_keras_cases as kc  # noqa: E402

#: the port against the JAX runner, both on the CPU in f32
PORT_VS_JAX = dict(atol=1e-6, rtol=1e-5)


def _convert(model, quantize=None):
    conv = tf.lite.TFLiteConverter.from_keras_model(model)
    if quantize is not None:
        conv.optimizations = [tf.lite.Optimize.DEFAULT]
    if quantize == "int8":
        def rep():
            rs = np.random.RandomState(0)
            for _ in range(4):
                yield [rs.rand(1, 4).astype(np.float32)]
        conv.representative_dataset = rep
        conv.target_spec.supported_ops = [
            tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
        conv.inference_input_type = tf.uint8
        conv.inference_output_type = tf.uint8
    return conv.convert()


def _interp(flat, inputs):
    it = tf.lite.Interpreter(model_content=flat)
    for d, x in zip(it.get_input_details(), inputs):
        it.resize_tensor_input(d["index"], x.shape)
    it.allocate_tensors()
    for d, x in zip(it.get_input_details(), inputs):
        it.set_tensor(d["index"], x)
    it.invoke()
    return [it.get_tensor(d["index"]) for d in it.get_output_details()]


def _elementwise_and_concat():
    a, b = tf.keras.Input((8,)), tf.keras.Input((8,))
    s = tf.keras.layers.Add()([a, b])
    d = tf.keras.layers.Subtract()([a, b])
    m1 = tf.keras.layers.Multiply()([s, d])
    cat = tf.keras.layers.Concatenate()([s, m1])
    return tf.keras.Model([a, b], tf.keras.layers.Activation("tanh")(cat))


def _mean_and_reshape():
    inp = tf.keras.Input((6, 4))
    r = tf.keras.layers.Reshape((12, 2))(inp)
    return tf.keras.Model(inp, tf.keras.layers.GlobalAveragePooling1D()(r))


def _dense_on_sequence():
    return tf.keras.Sequential([tf.keras.Input((4, 6)),
                                tf.keras.layers.Dense(3, activation="relu")])


#: name -> (model builder, inputs, the JAX test's atol)
CONVERTED = {
    "elementwise_and_concat": (
        _elementwise_and_concat,
        [np.random.RandomState(2).randn(2, 8).astype(np.float32)
         for _ in range(2)], 1e-5),
    "mean_and_reshape": (
        _mean_and_reshape,
        [np.random.RandomState(3).randn(2, 6, 4).astype(np.float32)], 1e-5),
    "dense_on_sequence_rank3": (
        _dense_on_sequence,
        [np.random.RandomState(5).randn(2, 4, 6).astype(np.float32)], 1e-5),
}


@pytest.fixture(scope="module")
def models():
    """name -> (flatbuffer bytes, inputs, atol): the committed MLP and
    CNN, and the other cases converted once."""
    xs = kc.tflite_inputs()
    out = {}
    for name, path in kc.TFLITE.items():
        with open(path, "rb") as f:
            out[name] = (f.read(), [xs[name]], 1e-4 if name == "cnn"
                         else 1e-5)
    tf.keras.utils.set_random_seed(0)
    for name, (build, inputs, atol) in CONVERTED.items():
        out[name] = (_convert(build()), inputs, atol)
    return out


@pytest.mark.parametrize("name", ["mlp", "cnn"] + list(CONVERTED))
def test_runner_against_jax_and_the_interpreter(models, name):
    flat, inputs, atol = models[name]
    golden = _interp(flat, inputs)
    port = TfliteRunner(flat, device="cpu")
    jax_runner = JTfliteRunner(flat)
    assert (port.input_names, port.output_names) == (
        jax_runner.input_names, jax_runner.output_names)
    got = port.run(list(inputs))
    ref = jax_runner.run(list(inputs))
    for n, g in zip(port.output_names, golden):
        o = got[n].numpy()
        assert o.shape == g.shape and o.dtype == g.dtype
        np.testing.assert_allclose(o, g, atol=atol, rtol=1e-4)
        np.testing.assert_allclose(o, np.asarray(ref[n].numpy()),
                                   **PORT_VS_JAX)
    # a second call replays the same signature (one census entry)
    again = port.run(list(inputs))
    for n in port.output_names:
        assert torch.equal(again[n].torch(), got[n].torch())
    assert [g["replays"] for g in port._run.graphs.report()] == [1]


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_committed_files_against_their_interpreter_goldens(models, name):
    """The files chip_smoke.py runs on the card: the port on the CPU
    against the goldens TF's Interpreter gave when they were made."""
    flat, inputs, atol = models[name]
    r = TfliteRunner(kc.TFLITE[name], device="cpu")
    got = r.run(inputs)[r.output_names[0]].numpy()
    np.testing.assert_allclose(got, kc.tflite_goldens()[name], atol=atol,
                               rtol=1e-4)


def test_named_inputs_and_errors_as_the_jax_runner(models):
    flat, inputs, _ = models["mlp"]
    port, jax_runner = TfliteRunner(flat, device="cpu"), JTfliteRunner(flat)
    x = inputs[0]
    out = port.run({port.input_names[0]: x})
    np.testing.assert_allclose(
        out[port.output_names[0]].numpy(),
        np.asarray(jax_runner.run({port.input_names[0]: x})[
            port.output_names[0]].numpy()), **PORT_VS_JAX)
    for r in (port, jax_runner):
        with pytest.raises(KeyError, match="missing input"):
            r.run({"nope": x})
        with pytest.raises(ValueError, match="takes 1 inputs"):
            r.run([x, x])
    for runner in (lambda d: TfliteRunner(d, device="cpu"), JTfliteRunner):
        with pytest.raises(ValueError, match="not a parseable"):
            runner(b"")
    # float64 comes in as float32, as under the JAX runner
    got = port.run([x.astype(np.float64)])[port.output_names[0]].numpy()
    assert got.dtype == np.float32


@pytest.mark.parametrize("quantize", ["int8", "dynamic_range"])
def test_quantized_models_refused_alike(quantize):
    tf.keras.utils.set_random_seed(0)
    width = 4 if quantize == "int8" else 64
    m = tf.keras.Sequential([tf.keras.Input((width,)),
                             tf.keras.layers.Dense(width // 2 or 2)])
    try:
        flat = _convert(m, quantize)
    except Exception:
        pytest.skip("full-int8 conversion unavailable in this TF build")
    for runner in (lambda d: TfliteRunner(d, device="cpu"), JTfliteRunner):
        with pytest.raises(ValueError, match="quantized tflite models are "
                                             "unsupported"):
            runner(flat)
