"""The port's recurrent path against the JAX package's: the recurrent ops
(``ops/recurrent.py``), the recurrent layers and their wrappers
(``nn/conf/layers.py``, ``nn/conf/layers_extra.py``) and the timestep
mask that ``MultiLayerNetwork`` threads through them, on the same numpy
inputs and, for networks, the same weights (``bridge.load_multilayer`` /
``load_graph`` of the JAX network's params). The port runs on the CPU.

Tolerances, each with its reason:
- op outputs and layer forwards, f32: atol 1e-5 plus rtol 1e-5
  (``F32``): the same gate formulas, products of a few terms summed in
  another order, carried over up to 6 steps;
- op gradients (autograd against ``jax.grad`` of one weighted sum of the
  first output): atol 1e-5 plus rtol 1e-5 (``GRAD``), the backward
  through 6 steps summing ~12 partial products in another order;
- network losses: rtol 1e-5 (``LOSS_RTOL``);
- params after 3 Adam steps at lr 1e-2: Adam divides each gradient by
  its own magnitude, so a weight whose gradient is ~0 on both sides may
  move by up to lr a step either way; on these batches none does, and
  params are held to atol 0.1 * lr (``ADAM_ATOL``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.learning as jlearn
import deeplearning4j_tpu.nn.conf.layers as JL
import deeplearning4j_tpu.nn.conf.layers_extra as jextra
import deeplearning4j_tpu.nn.graph as JG
import deeplearning4j_tpu.ops.recurrent as JR
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf.config import (InputType as JInputType,
                                               NeuralNetConfiguration as JNNC)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN

import deeplearning4j_tpu_torch.learning as tlearn
import deeplearning4j_tpu_torch.nn.conf.layers as TL
import deeplearning4j_tpu_torch.nn.conf.layers_extra as textra
import deeplearning4j_tpu_torch.nn.graph as TG
import deeplearning4j_tpu_torch.ops.recurrent as TR
from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn.conf.config import (
    InputType as TInputType, MultiLayerConfiguration as TConf,
    NeuralNetConfiguration as TNNC)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN

F32 = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-5)
LOSS_RTOL = 1e-5
LR = 1e-2
ADAM_ATOL = 0.1 * LR

B, T, IN, H = 3, 6, 4, 5
#: a keep-mask with a masked run inside a row, a leading masked step and
#: a row masked from the second step on
MASK = np.asarray([[1, 1, 0, 0, 1, 1],
                   [0, 1, 1, 1, 1, 1],
                   [1, 0, 0, 0, 0, 0]], bool)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


# -- the ops ---------------------------------------------------------------------

def _w(r, *s):
    return (0.5 * r.randn(*s)).astype(np.float32)


def _op_cases():
    """(id, op name, args maker, kwargs, takes a mask)."""
    lstm = lambda r: [_w(r, B, T, IN), _w(r, IN, 4 * H), _w(r, H, 4 * H),  # noqa: E731
                      _w(r, 4 * H)]
    gru_w = lambda r: [_w(r, IN + H, 2 * H), _w(r, IN + H, H), _w(r, 2 * H),  # noqa: E731
                       _w(r, H)]
    onnx = lambda r: [_w(r, 3 * H, IN), _w(r, 3 * H, H), _w(r, 6 * H)]  # noqa: E731
    rnn = lambda r: [_w(r, IN, H), _w(r, H, H), _w(r, H)]  # noqa: E731
    c = [
        ("lstm_cell", "lstm_cell",
         lambda r: [_w(r, B, IN), _w(r, B, H), _w(r, B, H)] + lstm(r)[1:],
         {"forget_bias": 1.0}, False),
        ("lstm_layer", "lstm_layer", lstm, {}, True),
        ("lstm_layer-h0-c0", "lstm_layer",
         lambda r: lstm(r) + [_w(r, B, H), _w(r, B, H)], {}, True),
        ("lstm_layer-last", "lstm_layer", lstm,
         {"return_sequence": False, "forget_bias": 1.0}, True),
        ("lstm_layer_bidirectional", "lstm_layer_bidirectional",
         lambda r: lstm(r) + lstm(r)[1:], {"mode": "mul"}, False),
        ("gru_cell", "gru_cell",
         lambda r: [_w(r, B, IN), _w(r, B, H)] + gru_w(r), {}, False),
        ("gru_block_cell", "gru_block_cell",
         lambda r: [_w(r, B, IN), _w(r, B, H)] + gru_w(r), {}, False),
        ("gru", "gru", lambda r: [_w(r, B, T, IN), _w(r, B, H)] + gru_w(r),
         {}, True),
        ("gru_onnx", "gru_onnx", lambda r: [_w(r, B, T, IN)] + onnx(r),
         {"time_major": False}, True),
        ("gru_onnx-linear-before-reset", "gru_onnx",
         lambda r: [_w(r, B, T, IN)] + onnx(r),
         {"time_major": False, "linear_before_reset": 1}, True),
        ("sru_cell", "sru_cell",
         lambda r: [_w(r, B, IN), _w(r, B, 3), _w(r, IN, 9), _w(r, 6)], {},
         False),
        ("sru", "sru",
         lambda r: [_w(r, B, T, IN), _w(r, B, 3), _w(r, IN, 9), _w(r, 6)],
         {}, False),
        ("sru_bi", "sru_bi",
         lambda r: [_w(r, T, B, IN), _w(r, IN, 9), _w(r, 6), _w(r, IN, 9),
                    _w(r, 6)], {"time_major": True}, False),
        ("simple_rnn", "simple_rnn", lambda r: [_w(r, B, T, IN)] + rnn(r),
         {}, True),
        ("lstm_block_cell", "lstm_block_cell",
         lambda r: [_w(r, B, IN), _w(r, B, H), _w(r, B, H),
                    _w(r, IN + H, 4 * H), _w(r, 4 * H), _w(r, H), _w(r, H),
                    _w(r, H)], {"clip_value": 0.3}, False),
        ("lstm_block", "lstm_block",
         lambda r: [_w(r, T, B, IN), _w(r, B, H), _w(r, B, H),
                    _w(r, IN + H, 4 * H), _w(r, 4 * H)],
         {"forget_bias": 0.5}, False),
        ("bidirectional_rnn", "bidirectional_rnn",
         lambda r: [_w(r, B, T, IN)] + rnn(r) + rnn(r), {}, False),
    ]
    out = []
    for cid, name, make, kw, maskable in c:
        out.append(pytest.param(name, make, kw, False, id=cid))
        if maskable:
            out.append(pytest.param(name, make, kw, True,
                                    id=f"{cid}-masked"))
    return out


@pytest.mark.parametrize("name,make,kw,masked", _op_cases())
def test_op_and_its_gradients_match_jax(name, make, kw, masked):
    arrays = make(np.random.RandomState(len(name)))
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if masked:
        jkw["mask"], tkw["mask"] = jnp.asarray(MASK), torch.from_numpy(MASK)
    jfn, tfn = getattr(JR, name), getattr(TR, name)
    jout = jfn(*[jnp.asarray(a) for a in arrays], **jkw)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tout = tfn(*leaves, **tkw)
    jl, tl = _leaves(jout), _leaves(tout)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **F32)
    w = np.random.RandomState(7).randn(*np.shape(jl[0])).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(_leaves(jfn(*a, **jkw))[0] * w),
                  argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    tg = torch.autograd.grad(torch.sum(tl[0] * torch.from_numpy(w)), leaves,
                             allow_unused=True)
    for i, (j, t) in enumerate(zip(jg, tg)):
        t = torch.zeros_like(leaves[i]) if t is None else t
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   err_msg=f"input {i}", **GRAD)


def test_masked_steps_carry_the_state():
    r = np.random.RandomState(0)
    x, wx, wh, b = (_w(r, B, T, IN), _w(r, IN, 4 * H), _w(r, H, 4 * H),
                    _w(r, 4 * H))
    h_seq, h_last, _ = TR.lstm_layer(*map(torch.from_numpy, (x, wx, wh, b)),
                                     mask=torch.from_numpy(MASK))
    # row 0: steps 2-3 repeat step 1; row 2: every step after 0 repeats it
    assert torch.equal(h_seq[0, 2], h_seq[0, 1])
    assert torch.equal(h_seq[0, 3], h_seq[0, 1])
    assert torch.equal(h_seq[2, 5], h_seq[2, 0])
    assert torch.equal(h_last[2], h_seq[2, 0])
    # a leading masked step keeps the zero initial state
    assert torch.equal(h_seq[1, 0], torch.zeros(H))
    with pytest.raises(ValueError, match="does not match sequence"):
        TR.lstm_layer(*map(torch.from_numpy, (x, wx, wh, b)),
                      mask=torch.ones(T, B, dtype=torch.bool))


@pytest.mark.parametrize("act", ["relu", "sigmoid"])
def test_simple_rnn_takes_an_activation_name_or_callable(act):
    r = np.random.RandomState(3)
    arrays = [_w(r, B, T, IN), _w(r, IN, H), _w(r, H, H), _w(r, H)]
    j, _ = JR.simple_rnn(*map(jnp.asarray, arrays),
                         activation=getattr(jax.nn, act),
                         mask=jnp.asarray(MASK))
    ta = [torch.from_numpy(a) for a in arrays]
    by_name, _ = TR.simple_rnn(*ta, activation=act,
                               mask=torch.from_numpy(MASK))
    by_fn, _ = TR.simple_rnn(*ta, activation=getattr(torch, act),
                             mask=torch.from_numpy(MASK))
    np.testing.assert_allclose(by_name.numpy(), np.asarray(j), **F32)
    assert torch.equal(by_name, by_fn)


# -- layers in networks -------------------------------------------------------------

def _mask_lstm(NNC, L, learning, InputType):
    """A MaskLayer in front of an LSTM and a temporal output head."""
    return (NNC.builder().seed(11).updater(learning.Adam(LR)).list()
            .layer(L.MaskLayer())
            .layer(L.LSTM(n_in=IN, n_out=H))
            .layer(L.RnnOutputLayer(n_in=H, n_out=3))
            .set_input_type(InputType.recurrent(IN, T)).build())


def _bidirectional(NNC, L, learning, InputType):
    """Bidirectional over the mask, then a Bidirectional LastTimeStep whose
    2-D halves are added."""
    return (NNC.builder().seed(12).updater(learning.Adam(LR)).list()
            .layer(L.MaskLayer())
            .layer(L.Bidirectional(fwd=L.GravesLSTM(n_in=IN, n_out=H)))
            .layer(L.Bidirectional(fwd=L.LastTimeStep(
                underlying=L.LSTM(n_in=2 * H, n_out=3)), mode="add"))
            .layer(L.OutputLayer(n_in=3, n_out=2))
            .set_input_type(InputType.recurrent(IN, T)).build())


def _rnn_stack(NNC, L, learning, InputType):
    """SimpleRnn, GRU, GRUResetAfter and a TimeDistributed dense layer
    under one mask, which reaches the temporal loss."""
    return (NNC.builder().seed(13).updater(learning.Adam(LR)).list()
            .layer(L.MaskLayer())
            .layer(L.SimpleRnn(n_in=IN, n_out=H, activation="relu"))
            .layer(L.GRU(n_in=H, n_out=4))
            .layer(EXTRA[L].GRUResetAfter(n_in=4, n_out=4))
            .layer(L.TimeDistributed(underlying=L.DenseLayer(
                n_in=4, n_out=6, activation="tanh")))
            .layer(L.RnnOutputLayer(n_in=6, n_out=3))
            .set_input_type(InputType.recurrent(IN, T)).build())


def _embedding_last(NNC, L, learning, InputType):
    """Token ids through EmbeddingSequenceLayer into a last-step LSTM."""
    return (NNC.builder().seed(14).updater(learning.Adam(LR)).list()
            .layer(L.EmbeddingSequenceLayer(n_in=11, n_out=IN))
            .layer(L.LSTM(n_in=IN, n_out=H, return_sequence=False))
            .layer(L.OutputLayer(n_in=H, n_out=2))
            .set_input_type(InputType.recurrent(1, T)).build())


def _mask_zero(NNC, L, learning, InputType):
    """MaskZeroLayer around an LSTM: zeroed outputs, no mask threaded."""
    return (NNC.builder().seed(15).updater(learning.Sgd(0.1)).list()
            .layer(L.MaskZeroLayer(underlying=L.LSTM(n_in=IN, n_out=H)))
            .layer(L.RnnOutputLayer(n_in=H, n_out=2, loss="mse",
                                    activation="identity"))
            .set_input_type(InputType.recurrent(IN, T)).build())


JAX_NS = (JNNC, JL, jlearn, JInputType)
TORCH_NS = (TNNC, TL, tlearn, TInputType)
#: GRUResetAfter is not re-exported by either package's layers.py
EXTRA = {JL: jextra, TL: textra}
CONFS = {"mask_lstm": _mask_lstm, "bidirectional": _bidirectional,
         "rnn_stack": _rnn_stack, "embedding_last": _embedding_last,
         "mask_zero": _mask_zero}


def _data(name, n=B, seed=0):
    """(x, y) for ``name``: right-padded sequences (zeros past each
    row's length) where the network masks."""
    r = np.random.RandomState(seed)
    if name == "embedding_last":
        x = r.randint(0, 11, (n, T)).astype(np.float32)
        return x, np.eye(2, dtype=np.float32)[r.randint(0, 2, n)]
    x = r.randn(n, IN, T).astype(np.float32)
    lengths = r.randint(2, T + 1, n)
    lengths[0] = T
    for i, L_ in enumerate(lengths):
        x[i, :, L_:] = 0.0
    if name == "bidirectional":
        return x, np.eye(2, dtype=np.float32)[r.randint(0, 2, n)]
    classes = 2 if name == "mask_zero" else 3
    y = np.zeros((n, classes, T), np.float32)
    for i in range(n):
        y[i, r.randint(0, classes, T), np.arange(T)] = 1.0
    return x, y


def _pair(jconf, tconf=None):
    """(JAX network, port network on the CPU) over one set of weights;
    the port's configuration from the JAX one's JSON unless given."""
    jnet = JMLN(jconf).init()
    tnet = TMLN(tconf or TConf.from_json(jconf.to_json()), device="cpu")
    bridge.load_multilayer(tnet, _np_tree(jnet._params),
                           _np_tree(jnet._updater_state), jnet._iteration)
    return jnet, tnet


def _close_params(tnet, jnet, atol):
    """Every leaf of the port's params (nested for a wrapper's) against
    the JAX network's."""
    def close(t, j, where):
        if isinstance(t, dict):
            assert sorted(t) == sorted(j), where
            for k in t:
                close(t[k], j[k], f"{where} {k}")
            return
        np.testing.assert_allclose(t.detach().numpy(), j, atol=atol, rtol=0,
                                   err_msg=where)
    ref = _np_tree(jnet._params)
    assert len(tnet._params) == len(ref)
    for i, (t, j) in enumerate(zip(tnet._params, ref)):
        close(t, j, f"layer {i}")


@pytest.mark.parametrize("name", sorted(CONFS))
def test_network_output_loss_and_fit_match_jax(name):
    jconf, tconf = CONFS[name](*JAX_NS), CONFS[name](*TORCH_NS)
    assert tconf.to_json() == jconf.to_json()
    assert tconf.layer_input_types() == jconf.layer_input_types()
    # GRUResetAfter's JSON loads in neither package (its class is not in
    # layers.py's namespace): that network is built from the port's DSL
    jnet, tnet = _pair(jconf, tconf if name == "rnn_stack" else None)
    x, y = _data(name)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x).jax()), **F32)
    if name in ("mask_lstm", "rnn_stack"):  # feed_forward threads the mask
        for tact, jact in zip(tnet.feed_forward(x), jnet.feed_forward(x)):
            np.testing.assert_allclose(tact.numpy(), np.asarray(jact.jax()),
                                       **F32)
    np.testing.assert_allclose(tnet.score(TDataSet(x, y)),
                               jnet.score(JDataSet(x, y)), rtol=LOSS_RTOL)
    batches = [_data(name, seed=s) for s in (1, 2, 3)]
    jnet.fit([JDataSet(a, b) for a, b in batches], num_epochs=1)
    tnet.fit([TDataSet(a, b) for a, b in batches], num_epochs=1)
    np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                               rtol=LOSS_RTOL)
    _close_params(tnet, jnet, ADAM_ATOL)


def test_mask_reaches_the_temporal_loss():
    """With a MaskLayer in front, the padded steps do not count in the
    loss: changing their labels leaves the score as it was."""
    _, tnet = _pair(_mask_lstm(*JAX_NS))
    x, y = _data("mask_lstm")
    y2 = y.copy()
    y2[:, :, -1] = np.roll(y2[:, :, -1], 1, axis=1)   # padded in rows 1, 2
    keep = np.any(x != 0, axis=1)
    assert not keep[1:, -1].any() and keep[0, -1]
    y2[0] = y[0]
    assert tnet.score(TDataSet(x, y)) == tnet.score(TDataSet(x, y2))


def test_rnn_loss_layer_matches_jax():
    r = np.random.RandomState(2)
    out = r.randn(B, 3, T).astype(np.float32)
    lab = np.zeros((B, 3, T), np.float32)
    lab[:, 0] = 1.0
    for loss, act in (("mcxent", "softmax"), ("mse", "identity")):
        jl, tl = (JL.RnnLossLayer(loss=loss, activation=act),
                  TL.RnnLossLayer(loss=loss, activation=act))
        jo = jl.forward({}, jnp.asarray(out))
        to = tl.forward({}, torch.from_numpy(out))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
        for mask in (None, MASK):
            jm = None if mask is None else jnp.asarray(mask)
            tm = None if mask is None else torch.from_numpy(mask)
            np.testing.assert_allclose(
                float(tl.compute_loss(torch.from_numpy(lab), to, tm)),
                float(jl.compute_loss(jnp.asarray(lab), jo, jm)),
                rtol=LOSS_RTOL)


@pytest.mark.parametrize("layer,keys", [
    ("LSTM", {"Wx": (IN, 4 * H), "Wh": (H, 4 * H), "b": (4 * H,)}),
    ("GRU", {"Wru": (IN + H, 2 * H), "Wc": (IN + H, H), "bru": (2 * H,),
             "bc": (H,)}),
    ("SimpleRnn", {"Wx": (IN, H), "Wh": (H, H), "b": (H,)}),
])
def test_params_keep_the_jax_keys_and_forget_bias(layer, keys):
    """The bridge maps keys one for one: the port's layer draws the JAX
    layer's keys and shapes; LSTM's forget block starts at 1."""
    jp = getattr(JL, layer)(n_in=IN, n_out=H).init_params(
        jax.random.key(0), (IN, T))
    tp = getattr(TL, layer)(n_in=IN, n_out=H).init_params(
        torch.Generator().manual_seed(0), (IN, T))
    assert {k: tuple(v.shape) for k, v in tp.items()} == keys
    assert {k: tuple(v.shape) for k, v in jp.items()} == keys
    if layer == "LSTM":
        assert torch.equal(tp["b"][H:2 * H], torch.ones(H))
        assert not tp["b"][:H].any() and not tp["b"][2 * H:].any()
    assert TL.GravesLSTM is TL.LSTM


def test_extra_layers_left_are_stubs_naming_their_item():
    jnames = {n for n, c in vars(jextra).items() if isinstance(c, type)
              and issubclass(c, JL.Layer) and c.__module__ == jextra.__name__}
    # every class is ported (the recurrent ones here, the rest in
    # test_torch_layers_extra.py) and builds into a configuration
    assert len(jnames) == 45
    for n in jnames:
        cls = getattr(textra, n)
        assert isinstance(cls, type) and issubclass(cls, TL.Layer), n
    TNNC.builder().list().layer(textra.GaussianNoise()).build()


def test_graph_runs_recurrent_layers_as_jax():
    """A ComputationGraph over an LSTM and a temporal head (no mask
    threaded, as in the JAX graph): outputs and 2 Adam steps."""
    def conf(NNC, L, G, learning, InputType):
        return (NNC.builder().seed(9).updater(learning.Adam(LR))
                .graph_builder().add_inputs("in")
                .set_input_types(InputType.recurrent(IN, T))
                .add_layer("lstm", L.LSTM(n_in=IN, n_out=H), "in")
                .add_layer("out", L.RnnOutputLayer(n_in=H, n_out=3), "lstm")
                .set_outputs("out").build())
    jconf = conf(JNNC, JL, JG, jlearn, JInputType)
    assert conf(TNNC, TL, TG, tlearn, TInputType).to_json() == \
        jconf.to_json()
    jnet = JG.ComputationGraph(jconf).init()
    tnet = TG.ComputationGraph(
        TG.ComputationGraphConfiguration.from_json(jconf.to_json()),
        device="cpu")
    bridge.load_graph(tnet, _np_tree(jnet._params),
                      _np_tree(jnet._updater_state), jnet._iteration)
    x, y = _data("mask_lstm")
    np.testing.assert_allclose(tnet.output(x)[0].numpy(),
                               np.asarray(jnet.output(x)[0].jax()), **F32)
    jnet.fit([JDataSet(x, y)] * 2, num_epochs=1)
    tnet.fit([TDataSet(x, y)] * 2, num_epochs=1)
    for n in ("lstm", "out"):
        for k, v in tnet._params[n].items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(jnet._params[n][k]),
                                       atol=ADAM_ATOL, rtol=0,
                                       err_msg=f"{n} {k}")


def _fault_cases():
    """Reference faults the port keeps as the JAX package has them
    (ROADMAP.md queue 3): (network builder, call, error)."""
    def gru_json(NNC, L, learning, InputType):
        return (NNC.builder().list()
                .layer(EXTRA[L].GRUResetAfter(n_in=IN, n_out=H))
                .layer(L.RnnOutputLayer(n_in=H, n_out=2))
                .set_input_type(InputType.recurrent(IN, T)).build())

    def bidirectional(NNC, L, learning, InputType):
        return (NNC.builder().list()
                .layer(L.Bidirectional(fwd=L.LSTM(n_in=IN, n_out=H)))
                .layer(L.RnnOutputLayer(n_in=2 * H, n_out=2))
                .set_input_type(InputType.recurrent(IN, T)).build())

    def rnn_loss(NNC, L, learning, InputType):
        return (NNC.builder().list().layer(L.LSTM(n_in=IN, n_out=3))
                .layer(L.RnnLossLayer())
                .set_input_type(InputType.recurrent(IN, T)).build())

    x = np.zeros((2, IN, T), np.float32)
    y = np.zeros((2, 3, T), np.float32)
    return [
        # GRUResetAfter is not in layers.py's namespace: its JSON does
        # not load
        pytest.param(gru_json, lambda conf, net, DS: type(conf).from_json(
            conf.to_json()), AttributeError, id="gru_reset_after_json"),
        # params() flattens one level: a wrapper's nested params break it
        pytest.param(bidirectional, lambda conf, net, DS: net.num_params(),
                     AttributeError, id="bidirectional_num_params"),
        # fit() takes no RnnLossLayer head
        pytest.param(rnn_loss, lambda conf, net, DS: net.fit([DS(x, y)]),
                     ValueError, id="rnn_loss_layer_fit"),
    ]


@pytest.mark.parametrize("build,call,error", _fault_cases())
def test_reference_faults_are_kept_alike(build, call, error):
    for ns, MLN, DS, kw in ((JAX_NS, JMLN, JDataSet, {}),
                            (TORCH_NS, TMLN, TDataSet, {"device": "cpu"})):
        conf = build(*ns)
        with pytest.raises(error):
            call(conf, MLN(conf, **kw).init(), DS)
