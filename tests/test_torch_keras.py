"""The port's Keras h5 importer (``modelimport/keras``) and its own HDF5
reader (``modelimport/h5.py``) against h5py, the JAX package's importer
and Keras's own ``predict``, on the CPU and on the same files.

- The reader against h5py on Keras-written files (the committed
  ResNet50V2 skeleton, filled and unfilled, and every file of the adapter
  sweep): every attribute, dataset, dtype, shape and value equal, the
  ``visititems`` order equal. h5py reads a filled skeleton as the filler
  drew it. h5py files with a filter, a chunked layout, a later format, a
  creation-ordered group or an enum are refused with the feature named.
- The adapter sweep of ``tests/test_modelimport.py`` (sequential,
  functional, multi-output; conv, recurrent, masking, wrappers): the port
  against ``keras.predict`` at each JAX test's own tolerance and against
  the JAX import at ``PORT_VS_JAX``; the params equal the JAX import's bit
  for bit.
- The committed tiny CNN against its committed Keras golden.
- Keras's ResNet50V2 from the filled skeleton: params against the h5's
  datasets, the port on the CPU against the committed Keras golden (row
  0, B=1) at tests/test_keras_applications.py's tolerance.

Each Keras model is built, saved and predicted once, in a module fixture.
"""
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")
keras = pytest.importorskip("keras")

from deeplearning4j_tpu.modelimport import ImportException as JImportException  # noqa: E402,E501
from deeplearning4j_tpu.modelimport.keras import importer as jimp  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import (ImportException,  # noqa: E402
                                                  h5)
from deeplearning4j_tpu_torch.modelimport.keras import importer as timp  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.conf import layers as TL  # noqa: E402

import torch_keras_cases as kc  # noqa: E402

#: the port against the JAX import, both on the CPU in f32
PORT_VS_JAX = dict(atol=1e-5, rtol=1e-5)


def _padded_seqs(rs, B=3, T=6, F=4):
    """tests/test_modelimport.py's padded sequences: leading, interior
    and trailing fully-masked steps."""
    x = rs.randn(B, T, F).astype(np.float32) + 0.5
    x[0, 4:, :] = 0.0
    x[1, 0, :] = 0.0
    x[2, 2, :] = 0.0
    return x


def _seq(*layers_, inp):
    return keras.Sequential([keras.Input(inp), *layers_])


def _functional_multi_output():
    from keras import layers
    inp = keras.Input((16,), name="in1")
    a = layers.Dense(8, activation="relu", name="fa")(inp)
    b = layers.Dense(8, activation="tanh", name="fb")(inp)
    merged = layers.Concatenate(name="cat")([a, b])
    added = layers.Add(name="addv")([a, b])
    out1 = layers.Dense(4, activation="softmax", name="out1")(merged)
    out2 = layers.Dense(2, name="out2")(added)
    return keras.Model(inputs=inp, outputs=[out1, out2])


def _functional_lstm_flatten():
    from keras import layers
    inp = keras.Input((5, 3), name="x")
    h = layers.LSTM(4, return_sequences=True, name="l")(inp)
    f = layers.Flatten(name="f")(h)
    return keras.Model(inp, layers.Dense(2, name="d")(f))


def _cases():
    """name -> (model builder, input, layout, atol): each a case of the
    JAX package's Keras tests (tests/test_modelimport.py) with its own
    tolerance. Layouts: ``nchw`` / ``ncdhw`` (channels moved first),
    ``nft`` ([B, T, F] -> [B, F, T]), ``as_is``."""
    from keras import layers as K
    rs = np.random.RandomState
    return {
        "sequential_cnn": (lambda: _seq(
            K.Conv2D(4, 3, activation="relu", padding="same", name="c1"),
            K.MaxPooling2D(2, name="p1"), K.BatchNormalization(name="bn1"),
            K.Flatten(name="f"), K.Dense(10, activation="softmax",
                                         name="d1"), inp=(8, 8, 3)),
            rs(0).randn(2, 8, 8, 3).astype(np.float32), "nchw", 1e-5),
        "sequential_lstm": (lambda: _seq(
            K.Embedding(20, 8, name="e1"), K.LSTM(6, name="l1"),
            K.Dense(3, activation="softmax", name="d2"), inp=(5,)),
            rs(1).randint(0, 20, (4, 5)), "as_is", 1e-5),
        "functional_multi_output": (_functional_multi_output,
                                    rs(2).randn(3, 16).astype(np.float32),
                                    "as_is", 1e-5),
        "conv_variants": (lambda: _seq(
            K.ZeroPadding2D(1, name="zp"),
            K.SeparableConv2D(6, 3, activation="relu", name="sc"),
            K.Conv2DTranspose(4, 3, strides=2, name="ct"),
            K.UpSampling2D(2, name="us"),
            K.Cropping2D(((1, 2), (2, 1)), name="cr"),
            K.GlobalAveragePooling2D(name="gap"),
            K.Dense(5, activation="softmax", name="d"), inp=(10, 10, 3)),
            rs(0).randn(2, 10, 10, 3).astype(np.float32), "nchw", 2e-5),
        "temporal_stack": (lambda: _seq(
            K.Conv1D(8, 3, padding="same", activation="relu", name="c1"),
            K.MaxPooling1D(2, name="p1"),
            K.Bidirectional(K.LSTM(4, return_sequences=True), name="bi"),
            K.GlobalMaxPooling1D(name="gmp"), K.Dense(3, name="d"),
            inp=(12, 5)),
            rs(1).randn(2, 12, 5).astype(np.float32), "nft", 1e-5),
        "gru_reset_after": (lambda: _seq(
            K.Embedding(15, 4, name="e"), K.GRU(5, reset_after=True,
                                                name="g"),
            K.Dense(2, activation="softmax", name="d"), inp=(6,)),
            rs(2).randint(0, 15, (3, 6)), "as_is", 1e-5),
        "gru_reset_before": (lambda: _seq(
            K.Embedding(15, 4, name="e"), K.GRU(5, reset_after=False,
                                                name="g"),
            K.Dense(2, activation="softmax", name="d"), inp=(6,)),
            rs(2).randint(0, 15, (3, 6)), "as_is", 1e-5),
        "timedistributed_layernorm_prelu": (lambda: _seq(
            K.TimeDistributed(K.Dense(9), name="td"),
            K.LayerNormalization(name="ln"),
            K.PReLU(shared_axes=[1], name="pr"),
            K.GlobalAveragePooling1D(name="gap"), K.Dense(2, name="d"),
            inp=(7, 6)),
            rs(3).randn(2, 7, 6).astype(np.float32), "nft", 1e-5),
        "conv3d_pool3d": (lambda: _seq(
            K.Conv3D(4, 3, activation="relu", name="c3"),
            K.MaxPooling3D(2, name="p3"), K.Flatten(name="f"),
            K.Dense(3, name="d"), inp=(6, 6, 6, 2)),
            rs(4).randn(2, 6, 6, 6, 2).astype(np.float32), "ncdhw", 2e-5),
        "reshape_permute": (lambda: _seq(
            K.Dense(12, activation="relu", name="d0"),
            K.Reshape((3, 4), name="rs"), K.Permute((2, 1), name="pm"),
            K.Flatten(name="f"), K.Dense(5, name="d1"), inp=(12,)),
            rs(3).randn(2, 12).astype(np.float32), "as_is", 1e-5),
        "masking_lstm_last_step": (lambda: _seq(
            K.Masking(mask_value=0.0, name="mk"), K.LSTM(5, name="l"),
            K.Dense(2, name="d"), inp=(6, 4)),
            _padded_seqs(rs(0)), "nft", 1e-5),
        "masking_gru_sequences": (lambda: _seq(
            K.Masking(mask_value=0.0, name="mk"),
            K.GRU(5, return_sequences=True, name="g"),
            K.GRU(3, name="g2"), inp=(6, 4)),
            _padded_seqs(rs(1)), "nft", 1e-5),
        "simple_rnn_conv1d_causal": (lambda: _seq(
            K.Conv1D(4, 2, padding="causal", dilation_rate=2, name="c"),
            K.SimpleRNN(5, return_sequences=True, name="r"),
            K.Flatten(name="f"), K.Dense(3, name="d"), inp=(8, 3)),
            rs(5).randn(2, 8, 3).astype(np.float32), "nft", 1e-5),
        "functional_lstm_flatten": (_functional_lstm_flatten,
                                    rs(8).randn(2, 5, 3).astype(np.float32),
                                    "nft", 1e-5),
    }


CASES = _cases()


def _ours(x, layout):
    if layout == "nchw":
        return x.transpose(0, 3, 1, 2)
    if layout == "ncdhw":
        return x.transpose(0, 4, 1, 2, 3)
    if layout == "nft":
        return x.transpose(0, 2, 1)
    return x


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """Every case saved by Keras and predicted once: name -> (path,
    golden outputs, is_sequential)."""
    keras.utils.set_random_seed(0)
    d = tmp_path_factory.mktemp("keras_sweep")
    out = {}
    for name, (build, x, _, _) in CASES.items():
        m = build()
        golden = m.predict(x, verbose=0)
        path = str(d / f"{name}.h5")
        m.save(path)
        out[name] = (path, golden if isinstance(golden, list)
                     else [golden], isinstance(m, keras.Sequential))
    return out


def _import(mod, path, sequential, **kw):
    k = mod.KerasModelImport
    return (k.import_keras_sequential_model_and_weights(path, **kw)
            if sequential else k.import_keras_model_and_weights(path, **kw))


def _outputs(net, x):
    out = net.output(x)
    return [np.asarray(o.numpy()) for o in
            (out if isinstance(out, list) else [out])]


# ---------------------------------------------------------------------------
# the HDF5 reader against h5py
# ---------------------------------------------------------------------------

def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(a, b)
    return type(a) is type(b) and a == b


def _assert_reads_like_h5py(source):
    """Every attribute, object, dataset (dtype, shape, values) and the
    visit order of the port's reading of ``source`` equal h5py's."""
    ours, theirs = h5.File(source), h5py.File(source, "r")
    try:
        names_o, names_t = [], []
        ours.visititems(lambda n, o: names_o.append(n))
        theirs.visititems(lambda n, o: names_t.append(n))
        assert names_o == names_t
        for name in [""] + names_t:
            o = ours[name] if name else ours
            t = theirs[name] if name else theirs
            assert sorted(o.attrs) == sorted(t.attrs), name
            for k in t.attrs:
                assert _same(o.attrs[k], t.attrs[k]), (name, k)
            if isinstance(t, h5py.Dataset):
                assert isinstance(o, h5.Dataset)
                assert (o.shape, o.dtype) == (t.shape, t.dtype), name
                assert _same(np.array(o), t[()]), name
            else:
                assert list(o.keys()) == list(t.keys()), name
        return len(names_t)
    finally:
        theirs.close()


def test_reader_equals_h5py_on_the_skeleton():
    assert _assert_reads_like_h5py(kc.SKELETON) > 500
    f = h5.File(kc.SKELETON)
    ds = f.datasets()
    assert len(ds) == 272 and all(d.data_address is None for d in ds)
    assert sum(d.size for d in ds) == kc.RESNET50V2_PARAMS
    cfg = f.attrs["model_config"]
    assert isinstance(cfg, str) and len(cfg) > 100_000   # a global heap


def test_filled_skeleton_reads_in_h5py_as_the_filler_drew_it(tmp_path):
    data = kc.fill_skeleton(seed=3)
    path = tmp_path / "filled.h5"
    path.write_bytes(data)
    rs = np.random.RandomState(3)
    with h5py.File(path, "r") as f:
        n = 0
        for d in h5.File(kc.SKELETON).datasets():
            want = kc._draw(d.name, d.shape, rs).astype(np.float32)
            assert np.array_equal(f[d.name][()], want), d.name
            n += 1
    assert n == 272 and len(data) % 8 == 0


def test_reader_equals_h5py_on_the_sweeps_files(sweep):
    for name, (path, _, _) in sweep.items():
        assert _assert_reads_like_h5py(path) > 0, name
        with open(path, "rb") as f:     # the same file from its bytes
            assert len(h5.File(f.read()).datasets()) == len(
                h5.File(path).datasets())


def _refused_file(path, kind):
    if kind == "gzip filter":
        with h5py.File(path, "w") as f:
            f.create_dataset("w", data=np.ones((8, 8), np.float32),
                             compression="gzip")
        return "filter pipeline"
    if kind == "chunked layout":
        with h5py.File(path, "w") as f:
            f.create_dataset("w", data=np.ones((8, 8), np.float32),
                             chunks=(4, 4))
        return "chunked data layout"
    if kind == "latest format":
        with h5py.File(path, "w", libver="latest") as f:
            f.create_dataset("w", data=np.ones(4, np.float32))
        return "superblock version"
    if kind == "creation-ordered group":
        with h5py.File(path, "w") as f:
            f.create_group("g", track_order=True).create_dataset(
                "w", data=np.ones(4, np.float32))
        return r"version-2 object header \(OHDR\)"
    if kind == "enum datatype":
        with h5py.File(path, "w") as f:
            f.create_dataset("w", data=np.array([True, False]))
        return "enum datatype"
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["gzip filter", "chunked layout",
                                  "latest format", "creation-ordered group",
                                  "enum datatype"])
def test_reader_refuses_an_unsupported_feature_naming_it(tmp_path, kind):
    path = str(tmp_path / "x.h5")
    what = _refused_file(path, kind)
    with pytest.raises(ImportException, match=what):
        f = h5.File(path)
        for d in f.datasets():
            d.read()


def test_reader_fill_value_and_not_hdf5(tmp_path):
    path = str(tmp_path / "fill.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("a", shape=(3, 2), dtype=np.float32, fillvalue=2.5)
        f.create_dataset("b", shape=(4,), dtype=np.int32)
    ours = h5.File(path)
    with h5py.File(path, "r") as f:
        assert np.array_equal(ours["a"].read(), f["a"][()])
        assert np.array_equal(ours["b"].read(), f["b"][()])
    assert np.all(ours["a"].read() == 2.5)
    with pytest.raises(OSError, match="not an HDF5 file"):
        h5.File(b"\0" * 64)


# ---------------------------------------------------------------------------
# the importer against Keras and the JAX package
# ---------------------------------------------------------------------------

def _assert_same_params(ours, theirs, where=()):
    """The port's param tree equals the JAX one's, leaf for leaf."""
    if isinstance(theirs, dict):
        assert sorted(ours) == sorted(theirs), where
        for k in theirs:
            _assert_same_params(ours[k], theirs[k], where + (k,))
    elif isinstance(theirs, list):
        assert len(ours) == len(theirs), where
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _assert_same_params(a, b, where + (i,))
    else:
        assert np.array_equal(ours.numpy(), np.asarray(theirs)), where


@pytest.mark.parametrize("name", list(CASES))
def test_adapter_sweep_against_keras_and_jax(sweep, name):
    path, golden, sequential = sweep[name]
    _, x, layout, atol = CASES[name]
    xin = _ours(x, layout)
    port = _import(timp, path, sequential, device="cpu")
    jax_net = _import(jimp, path, sequential)
    got, ref = _outputs(port, xin), _outputs(jax_net, xin)
    assert len(got) == len(golden)
    for g, r, k in zip(got, ref, golden):
        np.testing.assert_allclose(g, k, atol=atol)        # the JAX test's
        np.testing.assert_allclose(g, r, **PORT_VS_JAX)
    _assert_same_params(port._params, jax_net._params)


def test_committed_tiny_cnn_against_its_golden():
    """The file the card test imports: the port on the CPU against Keras's
    committed golden (the JAX test's 1e-5) and the JAX import."""
    x = kc.keras_tiny_input().transpose(0, 3, 1, 2).copy()
    port = timp.import_keras_sequential_model_and_weights(kc.KERAS_TINY,
                                                          device="cpu")
    got = port.output(x).numpy()
    np.testing.assert_allclose(got, kc.keras_tiny_golden(), atol=1e-5)
    ref = jimp.import_keras_sequential_model_and_weights(kc.KERAS_TINY)
    np.testing.assert_allclose(got, np.asarray(ref.output(x).numpy()),
                               **PORT_VS_JAX)
    _assert_reads_like_h5py(kc.KERAS_TINY)


def test_read_h5_equals_the_jax_reading_with_and_without_weight_names(
        sweep, tmp_path):
    """``_read_h5`` gives the JAX reading: each layer's weights in
    ``weight_names`` order, and where a group has no ``weight_names``
    every dataset in ``visititems`` order."""
    src = sweep["conv_variants"][0]
    path = str(tmp_path / "no_names.h5")
    with open(src, "rb") as f, open(path, "wb") as g:
        g.write(f.read())
    with h5py.File(path, "a") as f:
        for lname in ("sc", "d"):
            del f["model_weights"][lname].attrs["weight_names"]
    for p in (src, path):
        cfg_t, w_t = timp._read_h5(p)
        cfg_j, w_j = jimp._read_h5(p)
        assert cfg_t == cfg_j and list(w_t) == list(w_j)
        for lname in w_j:
            assert len(w_t[lname]) == len(w_j[lname])
            for a, b in zip(w_t[lname], w_j[lname]):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_lambda_layer_registry_and_refusals(tmp_path):
    from keras import layers
    m = keras.Sequential([keras.Input((4,)), layers.Dense(3, name="d"),
                          layers.Lambda(lambda t: t * 2.0, name="twice"),
                          layers.Dense(2, name="d2")])
    path = str(tmp_path / "lam.h5")
    m.save(path)
    for mod, exc in ((timp, ImportException), (jimp, JImportException)):
        with pytest.raises(exc, match="register_lambda"):
            mod.import_keras_sequential_model_and_weights(
                path, **({"device": "cpu"} if mod is timp else {}))
    timp.register_lambda("twice", lambda: TL.ActivationLayer(
        activation="identity", name="twice"))
    try:
        net = timp.import_keras_sequential_model_and_weights(path,
                                                             device="cpu")
        assert isinstance(net.layers[1], TL.ActivationLayer)
    finally:
        timp._LAMBDA_REGISTRY.pop("twice", None)
    with pytest.raises(ImportException, match="LSTM"):
        timp._adapt_layer("LSTM", {"units": 4, "activation": "relu"}, None)
    with pytest.raises(ImportException, match="not a Sequential"):
        timp.import_keras_sequential_model_and_weights(
            kc.SKELETON, device="cpu")


def test_resnet50v2_filled_skeleton_against_the_keras_golden(tmp_path):
    """Keras's ResNet50V2 from the filled skeleton on the CPU: every
    param equals its dataset; row 0 of the golden batch at B=1 within
    the JAX test's tolerance, its argmax held."""
    path = kc.write_filled(str(tmp_path / "r50v2.h5"))
    net = timp.import_keras_model_and_weights(path, device="cpu")
    _, weights = timp._read_h5(path)
    assert sum(t.numel() for p in net._params.values()
               for t in p.values()) == kc.RESNET50V2_PARAMS
    conv = net._params["conv1_conv"]
    assert np.array_equal(conv["W"].numpy(), weights["conv1_conv"][0])
    bn = net._params["post_bn"]
    assert np.array_equal(bn["state_var"].numpy(), weights["post_bn"][3])
    with np.load(kc.GOLDEN) as z:
        golden = z["golden"]
    x = kc.resnet_batch()[:1]
    with torch.no_grad():
        out = net.output(x.transpose(0, 3, 1, 2).copy())[0].numpy()
    assert kc.check_against_golden(out, golden[:1])
    assert 0.2 < golden.max() < 0.5           # neither flat nor saturated
