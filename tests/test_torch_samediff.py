"""The port's SameDiff (``deeplearning4j_tpu_torch/autodiff``) against the
JAX package's: each graph is recorded the same way on both sides and run
on the same numpy inputs; the port runs on the CPU (``device="cpu"``).

The port's counterparts of ``tests/test_samediff.py``,
``tests/test_samediff_eager.py``, ``tests/test_controlflow.py``,
``tests/test_grad_accum.py::TestSameDiffAccum`` and
``tests/test_golden_integration.py::TestGoldenSameDiff``.

Tolerances, each with its reason:
- forward values of small f32 graphs: atol 1e-6 plus rtol 1e-6
  (``F32``), the same ops summed in another order;
- gradients: atol 1e-5 plus rtol 1e-5 (``GRAD``): a gradient through a
  5-step recurrent product sums ~10 partial products in another order;
- training: parameters after a few Adam / SGD steps within 1e-5
  (``TRAIN``), each step moving a weight by lr times an f32 gradient
  that differs by ~1e-7; the golden losses to rtol 2e-3, the JAX test's
  own tolerance;
- a graph saved by one package and loaded by the other gives outputs
  within 1e-6 (``F32``).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff.training import TrainingConfig as JTC
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JListIt
from deeplearning4j_tpu.learning import Adam as JAdam, Sgd as JSgd

from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch.autodiff import gradcheck, listeners
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff as TSameDiff
from deeplearning4j_tpu_torch.autodiff.training import TrainingConfig as TTC
from deeplearning4j_tpu_torch.autodiff.validation import (OpValidation,
                                                          TestCase)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.datasets.iterators import \
    ListDataSetIterator as TListIt
from deeplearning4j_tpu_torch.learning import Adam as TAdam, Sgd as TSgd

F32 = dict(atol=1e-6, rtol=1e-6)
TRAIN = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-5)


def jsd(**kw):
    return JSameDiff.create(**kw)


def tsd(**kw):
    return TSameDiff.create(device="cpu", **kw)


def _np(a):
    return np.asarray(a.numpy() if hasattr(a, "numpy") else a)


# -- graphs recorded the same way on both sides --------------------------------

def g_arithmetic(sd):
    a = sd.constant(np.asarray([1.0, 2.0], np.float32), "a")
    b = sd.constant(np.asarray([3.0, 4.0], np.float32), "b")
    return {}, [a + b, a - b * 2.0, (a / b) ** 2.0, -a, 3.0 - a, 1.0 / b]


def g_placeholder_mmul(sd):
    x = sd.placeholder("x", (None, 2))
    w = sd.var("w", np.asarray([[1.0], [1.0]], np.float32))
    return {"x": np.asarray([[2.0, 3.0]], np.float32)}, [x.mmul(w), x @ w]


def g_namespaces(sd):
    x = sd.constant(np.asarray([[1.0, 1.0], [0.5, -2.0]], np.float32), "x")
    e = sd.constant(np.asarray([np.e], np.float32), "e")
    return {}, [sd.nn.softmax(x), sd.math.log(e), sd.math.pow(x, 2.0),
                sd.nn.relu(x), sd.math.floor(x), sd.nn.leaky_relu(x),
                sd.math.gt(x, 0.0), sd.math.mmul(x, x)]


def g_chained(sd):
    x = sd.placeholder("x", (2, 2))
    return {"x": np.ones((2, 2), np.float32)}, [(x * 2.0 + 1.0).sum()]


def g_reduce_methods(sd):
    x = sd.constant(np.asarray([[1.0, 2.0], [3.0, 4.0]], np.float32), "x")
    return {}, [x.mean(), x.sum(0), x.argmax(1), x.max(1), x.min(),
                x.std(1), x.norm2(), x.rank(), x.cast("int32"),
                x.transpose(), x.reshape(4), x.dot(x)]


def g_multi_output(sd):
    x = sd.placeholder("x", (2,))
    y = x * 2.0
    z = y + 1.0
    return {"x": np.ones(2, np.float32)}, [y, z]


def g_getitem(sd):
    x = sd.placeholder("x", (4, 6))
    idx = sd.constant(np.asarray([2, 0], np.int32), "idx")
    return ({"x": np.arange(24, dtype=np.float32).reshape(4, 6)},
            [x[1:3, ::2] * 2.0, x[0] + x[-1], x[..., 0], x[:, None, 1],
             x[::-1, 1:5:2], x[idx]])


def g_loss_namespace(sd):
    p = sd.placeholder("p", (3, 4))
    y = sd.placeholder("y", (3, 4))
    r = np.random.RandomState(0)
    return ({"p": r.randn(3, 4).astype(np.float32),
             "y": r.randn(3, 4).astype(np.float32)},
            [sd.loss.mean_squared_error(p, None, y),
             sd.loss.huber(p, None, y), sd.loss.absolute_difference(p, None, y),
             sd.loss.sparse_softmax_cross_entropy(
                 sd.constant(np.asarray([0, 3, 1], np.int32)), p)])


def g_cond_both_branches(sd):
    x = sd.placeholder("x", (3,))
    outs = []
    for pred in (True, False):
        outs.append(sd.cond(sd.constant(np.asarray(pred)),
                            lambda a: a * 2.0, lambda a: a - 2.0, x))
    return {"x": np.ones(3, np.float32)}, outs


def g_while_counter(sd):
    i0 = sd.constant(np.asarray(0.0, np.float32))
    acc0 = sd.constant(np.asarray(1.0, np.float32))
    i_f, acc_f = sd.while_loop(lambda i, acc: i < 5.0,
                               lambda i, acc: (i + 1.0, acc * 2.0), i0, acc0)
    return {}, [i_f, acc_f]


def g_scan_cumsum(sd):
    xs = sd.placeholder("xs", (4,))
    c0 = sd.constant(np.asarray(0.0, np.float32))
    final, ys = sd.scan(lambda c, x: (c + x, c + x), c0, xs)
    final_r, ys_r = sd.scan(lambda c, x: (c + x, c * 1.0), c0, xs,
                            reverse=True)
    return ({"xs": np.asarray([1, 2, 3, 4], np.float32)},
            [final, ys, final_r, ys_r])


def g_tensor_array(sd):
    ta = sd.tensor_array(3, (2,))
    a = sd.constant(np.asarray([1.0, 2.0], np.float32))
    b = sd.constant(np.asarray([3.0, 4.0], np.float32))
    ta.write(0, a).write(2, b)
    return {}, [ta.stack(), ta.read(2)]


def g_name_scope(sd):
    with sd.name_scope("layer1"):
        v = sd.var("w", np.ones(2, np.float32))
    assert v.name == "layer1/w"
    return {}, [v * 3.0]


GRAPHS = [g_arithmetic, g_placeholder_mmul, g_namespaces, g_chained,
          g_reduce_methods, g_multi_output, g_getitem, g_loss_namespace,
          g_cond_both_branches, g_while_counter, g_scan_cumsum,
          g_tensor_array, g_name_scope]


def _run(mk, build):
    sd = mk()
    ph, outs = build(sd)
    res = sd.output(ph, outs)
    return sd, [_np(res[v.name]) for v in outs], [v.name for v in outs]


@pytest.mark.parametrize("build", GRAPHS, ids=lambda f: f.__name__[2:])
def test_graph_matches_jax(build):
    _, jout, jnames = _run(jsd, build)
    tsd_, tout, tnames = _run(tsd, build)
    assert jnames == tnames
    for j, t in zip(jout, tout):
        assert j.dtype == t.dtype and j.shape == t.shape
        np.testing.assert_allclose(t, j, **F32)
    # eval() of one variable is output() of it
    sd = tsd()
    ph, outs = build(sd)
    np.testing.assert_allclose(_np(outs[-1].eval(ph)),
                               _np(sd.output(ph, [outs[-1]])[outs[-1].name]))


def g_op_tail(sd):
    m = np.asarray([[2.0, 0.5], [0.25, 1.5]], np.float32)
    x = sd.constant(m, "m")
    bits = sd.constant(np.asarray([[6, 5], [-3, 12]], np.int32), "bits")
    data = sd.constant(np.asarray([1.0, 2.0, 3.0, 4.0], np.float32), "d")
    ids = sd.constant(np.asarray([0, 0, 2, 1], np.int32), "ids")
    return {}, [sd.linalg.inverse(x), sd.linalg.det(x),
                sd.bitwise.and_(bits, bits * 3),
                sd.bitwise.left_shift(bits, bits),
                sd.math.segment_sum(data, ids, num_segments=3),
                sd.math.unsorted_segment_max(data, ids, num_segments=4)]


def test_op_tail_through_namespaces_matches_jax():
    """``sd.linalg``, ``sd.bitwise`` and the segment names reach the op
    tail and agree with the JAX ``SameDiff``; an unknown name raises."""
    _, jout, jnames = _run(jsd, g_op_tail)
    _, tout, tnames = _run(tsd, g_op_tail)
    assert jnames == tnames
    for j, t in zip(jout, tout):
        assert j.dtype == t.dtype and j.shape == t.shape
        np.testing.assert_allclose(t, j, **F32)
    with pytest.raises(AttributeError):
        tsd().math.no_such_op(tsd().constant(np.ones(2, np.float32)))


# -- gradients ------------------------------------------------------------------

def g_grad_graph(sd):
    r = np.random.RandomState(1)
    x = sd.placeholder("x", (4, 3))
    w = sd.var("w", r.randn(3, 2).astype(np.float32))
    b = sd.var("b", r.randn(2).astype(np.float32))
    h = sd.nn.gelu(x.mmul(w) + b)
    loss = sd.nn.log_softmax(h).mean() + (w * w).sum() * 0.1
    sd.set_loss_variables(loss)
    return {"x": r.randn(4, 3).astype(np.float32)}, ["w", "b"]


def g_cond_grad(sd):
    w = sd.var("w", np.asarray([2.0, 3.0], np.float32))
    a, b = sd.cond(sd.constant(np.asarray(True)),
                   lambda v: (v * v, v + 1.0), lambda v: (v, v), w)
    sd.set_loss_variables((a + b).sum())
    return {}, ["w"]


def g_scan_grad(sd):
    rs = np.random.RandomState(0)
    x = sd.placeholder("x", (5, 2, 3))
    w = sd.var("w", rs.randn(3, 3).astype(np.float32) * 0.5)
    h0 = sd.constant(np.zeros((2, 3), np.float32))
    final_h, _ = sd.scan(lambda h, x_t: (x_t.mmul(w) + h,) * 2,
                         init=[h0], xs=[x])
    sd.set_loss_variables(sd.math.tanh(final_h).sum())
    return {"x": rs.randn(5, 2, 3).astype(np.float32)}, ["w"]


@pytest.mark.parametrize("build", [g_grad_graph, g_cond_grad, g_scan_grad],
                         ids=lambda f: f.__name__[2:])
def test_calculate_gradients_match_jax(build):
    grads = []
    for mk in (jsd, tsd):
        sd = mk()
        ph, wrt = build(sd)
        g = sd.calculate_gradients(ph, wrt)
        grads.append({n: _np(v) for n, v in g.items()})
    for n in grads[0]:
        np.testing.assert_allclose(grads[1][n], grads[0][n], **GRAD)


def test_cond_grad_value():
    sd = tsd()
    _, wrt = g_cond_grad(sd)
    g = sd.calculate_gradients({}, wrt)["w"].numpy()
    np.testing.assert_allclose(g, [5.0, 7.0])   # d/dw (w^2 + w + 1)


def test_gradcheck_utilities():
    gradcheck.check_gradients(lambda x: torch.sum(torch.tanh(x) ** 2),
                              [np.asarray([0.3, -0.5, 1.2], np.float32)])
    sd = tsd()
    x = sd.placeholder("x", (3,))
    w = sd.var("w", np.asarray([0.5, -0.3, 0.8], np.float32))
    loss = sd.invoke("reduce_sum", sd.invoke("sigmoid", x * w))
    sd.set_loss_variables(loss)
    assert gradcheck.check_samediff_gradients(
        sd, {"x": np.asarray([1.0, 2.0, 3.0], np.float32)}, loss.name)
    with pytest.raises(AssertionError, match="gradient mismatch"):
        gradcheck.check_gradients(_wrong_grad, [np.ones(2, np.float32)])


class _WrongGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * x

    @staticmethod
    def backward(ctx, g):
        return g * 3.0


def _wrong_grad(x):
    return torch.sum(_WrongGrad.apply(x))


def test_op_validation_testcase():
    tc = TestCase("tanh", [np.asarray([0.1, -0.4, 0.9], np.float32)],
                  device="cpu").expect_fn(np.tanh).grad_check()
    assert OpValidation.validate(tc) is None
    bad = TestCase("tanh", [np.asarray([0.1], np.float32)],
                   device="cpu").expect([5.0])
    assert "forward mismatch" in OpValidation.validate(bad)
    assert "tanh" in OpValidation.validated_ops()
    rep = OpValidation.coverage_report()
    # every op of the JAX registry (561 names less aliases) is registered
    assert rep["total"] == 561 and rep["validated"] >= 1


# -- eager mode -------------------------------------------------------------------

def test_eager_values_available_at_definition():
    for mk in (jsd, tsd):
        sd = mk(eager=True)
        x = sd.var("x", np.asarray([[1.0, 2.0], [3.0, 4.0]], np.float32))
        y = x * 2.0 + 1.0
        np.testing.assert_allclose(y.get_arr().numpy(), [[3, 5], [7, 9]])


def test_eager_enable_mid_build_and_placeholder_gate():
    sd = tsd()
    x = sd.var("x", np.asarray([2.0], np.float32))
    a = x + 1.0
    assert sd.eager_arr(a.name) is None
    sd.enable_eager_mode()
    assert sd.is_eager_mode()
    b = a * 3.0
    assert sd.eager_arr(b.name) is None
    c = x * 5.0
    np.testing.assert_allclose(sd.eager_arr(c.name).numpy(), [10.0])
    sd = tsd(eager=True)
    p = sd.placeholder("p", shape=(2,))
    w = sd.var("w", np.asarray([10.0, 20.0], np.float32))
    out1 = p + w
    assert sd.eager_arr(out1.name) is None
    sd.set_array("p", np.asarray([1.0, 2.0], np.float32))
    out2 = p + w
    np.testing.assert_allclose(sd.eager_arr(out2.name).numpy(), [11, 22])


def test_eager_matches_the_define_then_run_path_and_failure_is_nonfatal():
    sd = tsd(eager=True)
    x = sd.var("x", np.asarray([[1.0, 2.0]], np.float32))
    out = sd._record("multiply", [x, sd.constant(3.0, "k")], out_name="y")
    np.testing.assert_allclose(sd.eager_arr(out.name).numpy(),
                               sd.output({}, [out.name])[out.name].numpy())
    p = sd.placeholder("p", shape=(3,))
    o = p * 2.0
    assert sd.eager_arr(o.name) is None
    np.testing.assert_allclose(
        o.eval({"p": np.asarray([1.0, 2.0, 3.0], np.float32)}).numpy(),
        [2, 4, 6])


# -- training ---------------------------------------------------------------------

def _regression(mk, updater, accum=0, remat=None):
    sd = mk()
    x = sd.placeholder("x", (None, 3))
    y = sd.placeholder("y", (None, 1))
    w = sd.var("w", np.zeros((3, 1), np.float32))
    b = sd.var("b", np.zeros(1, np.float32))
    pred = x.mmul(w) + b
    loss = sd.loss.mean_squared_error(pred, None, y)
    sd.set_loss_variables(loss)
    cfg = (JTC if mk is jsd else TTC)(
        updater=updater, data_set_feature_mapping=["x"],
        data_set_label_mapping=["y"], grad_accum=accum, remat=remat)
    sd.set_training_config(cfg)
    return sd


def _xy(n=64, seed=0):
    X = np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    Y = (X @ np.array([[1.0], [-2.0], [0.5]])).astype(np.float32)
    return X, Y


def _it(mk, X, Y, bs):
    if mk is jsd:
        return JListIt([JDataSet(X[i:i + bs], Y[i:i + bs])
                        for i in range(0, len(X), bs)])
    return TListIt([TDataSet(X[i:i + bs], Y[i:i + bs])
                    for i in range(0, len(X), bs)])


def test_fit_linear_regression_matches_jax():
    X, Y = _xy(200)
    runs = []
    for mk, upd in ((jsd, JAdam(learning_rate=0.1)),
                    (tsd, TAdam(learning_rate=0.1))):
        sd = _regression(mk, upd)
        h = sd.fit(_it(mk, X, Y, 50), num_epochs=30)
        runs.append((h, _np(sd.get_arr_for_var("w"))))
    (jh, jw), (th, tw) = runs
    assert th.final_loss() < 1e-2
    np.testing.assert_allclose(tw, [[1.0], [-2.0], [0.5]], atol=0.1)
    np.testing.assert_allclose(tw, jw, **TRAIN)
    np.testing.assert_allclose([c.mean_loss() for c in th.loss_curves],
                               [c.mean_loss() for c in jh.loss_curves],
                               atol=1e-5, rtol=1e-4)
    assert th.epochs == 30 and th.iterations == 120


def _lstm_classifier(mk, updater):
    """``sd.rnn.lstm_layer`` over [B, T=5, 3] into a 2-way softmax on its
    last state."""
    r = np.random.RandomState(4)
    sd = mk()
    x = sd.placeholder("x", (None, 5, 3))
    y = sd.placeholder("y", (None, 2))
    wx = sd.var("wx", 0.5 * r.randn(3, 16).astype(np.float32))
    wh = sd.var("wh", 0.5 * r.randn(4, 16).astype(np.float32))
    b = sd.var("b", np.zeros(16, np.float32))
    wo = sd.var("wo", 0.5 * r.randn(4, 2).astype(np.float32))
    _, h_last, _ = sd.rnn.lstm_layer(x, wx, wh, b, n_outputs=3)
    loss = sd.loss.softmax_cross_entropy(h_last.mmul(wo), None, y)
    sd.set_loss_variables(loss)
    sd.set_training_config((JTC if mk is jsd else TTC)(
        updater=updater, data_set_feature_mapping=["x"],
        data_set_label_mapping=["y"]))
    return sd


def test_lstm_layer_trains_in_a_graph_as_jax():
    """A recurrent op recorded through ``sd.rnn`` trains: the loss falls
    and the weights after 3 epochs of Adam equal the JAX graph's."""
    r = np.random.RandomState(5)
    X = r.randn(32, 5, 3).astype(np.float32)
    Y = np.eye(2, dtype=np.float32)[(X[:, :, 0].sum(1) > 0).astype(int)]
    runs = []
    for mk, upd in ((jsd, JAdam(learning_rate=0.05)),
                    (tsd, TAdam(learning_rate=0.05))):
        sd = _lstm_classifier(mk, upd)
        h = sd.fit(_it(mk, X, Y, 8), num_epochs=3)
        runs.append((h, {n: _np(sd.get_arr_for_var(n))
                         for n in ("wx", "wh", "b", "wo")}))
    (jh, jw), (th, tw) = runs
    curve = [c.mean_loss() for c in th.loss_curves]
    assert curve[-1] < curve[0]
    np.testing.assert_allclose(curve, [c.mean_loss() for c in jh.loss_curves],
                               **TRAIN)
    for n in tw:
        np.testing.assert_allclose(tw[n], jw[n], err_msg=n, **TRAIN)


def test_grad_accum_matches_full_batch_and_jax():
    """TrainingConfig(grad_accum=4) == full batch for the batch-mean MSE,
    and equals the JAX package's accumulated run."""
    X, Y = _xy(64)
    full = _regression(tsd, TSgd(0.1))
    acc = _regression(tsd, TSgd(0.1), accum=4)
    jacc = _regression(jsd, JSgd(0.1), accum=4)
    h1 = full.fit(_it(tsd, X, Y, 64), num_epochs=5)
    h2 = acc.fit(_it(tsd, X, Y, 64), num_epochs=5)
    h3 = jacc.fit(_it(jsd, X, Y, 64), num_epochs=5)
    np.testing.assert_allclose([c.mean_loss() for c in h2.loss_curves],
                               [c.mean_loss() for c in h1.loss_curves],
                               atol=1e-5)
    for a, b in ((acc, full), (acc, jacc)):
        np.testing.assert_allclose(_np(a.get_arr_for_var("w")),
                                   _np(b.get_arr_for_var("w")), **TRAIN)
    np.testing.assert_allclose([c.mean_loss() for c in h2.loss_curves],
                               [c.mean_loss() for c in h3.loss_curves],
                               atol=1e-5)
    with pytest.raises(ValueError, match="does not divide"):
        _regression(tsd, TSgd(0.1), accum=3).fit(_it(tsd, X, Y, 64))


@pytest.mark.parametrize("remat", ["dots_saveable", "layer"])
def test_remat_matches_none(remat):
    X, Y = _xy(64)
    s1 = _regression(tsd, TSgd(0.1))
    s2 = _regression(tsd, TSgd(0.1), remat=remat)
    s1.fit(_it(tsd, X, Y, 64), num_epochs=4)
    s2.fit(_it(tsd, X, Y, 64), num_epochs=4)
    np.testing.assert_allclose(s2.get_arr_for_var("w").numpy(),
                               s1.get_arr_for_var("w").numpy(), atol=1e-6)


def _golden_data(rs, b, f, c):
    x = rs.randn(b, f).astype(np.float32)
    y = np.zeros((b, c), np.float32)
    y[np.arange(b), rs.randint(0, c, b)] = 1.0
    return x, y


def test_golden_samediff_trajectory():
    """``tests/test_golden_integration.py::TestGoldenSameDiff``'s graph
    and golden losses (rtol 2e-3, that test's tolerance), with the
    regularizers and the decoupled decay on as well, against JAX."""
    golden = [1.38945, 1.296639, 1.214418, 1.141212, 1.075134]
    results = []
    for mk, cfg_cls, upd, it, extra in (
            (tsd, TTC, TAdam(learning_rate=0.05), TListIt, {}),
            (tsd, TTC, TAdam(learning_rate=0.05), TListIt,
             {"l1": 1e-3, "l2": 1e-2, "weight_decay": 1e-3}),
            (jsd, JTC, JAdam(learning_rate=0.05), JListIt,
             {"l1": 1e-3, "l2": 1e-2, "weight_decay": 1e-3})):
        rs = np.random.RandomState(5)
        sd = mk()
        x = sd.placeholder("x", (16, 6))
        y = sd.placeholder("y", (16, 3))
        w = sd.var("w", rs.randn(6, 3).astype(np.float32) * 0.5)
        b = sd.var("b", np.zeros(3, np.float32))
        logits = x.mmul(w) + b
        loss = sd.invoke("softmax_cross_entropy_loss_with_logits",
                         logits, sd.nn.softmax(y * 8.0)).mean()
        loss.rename("loss")
        sd.set_loss_variables("loss")
        sd.set_training_config(cfg_cls(
            updater=upd, data_set_feature_mapping=["x"],
            data_set_label_mapping=["y"], **extra))
        xs, ys = _golden_data(rs, 16, 6, 3)
        ds = (TDataSet if mk is tsd else JDataSet)(xs, ys)
        hist = sd.fit(it([ds]), num_epochs=5)
        results.append(([float(v) for c in hist.loss_curves
                         for v in c.losses], _np(sd.get_arr_for_var("w"))))
    np.testing.assert_allclose(results[0][0], golden, rtol=2e-3)
    np.testing.assert_allclose(results[1][0], results[2][0], atol=1e-5)
    np.testing.assert_allclose(results[1][1], results[2][1], **TRAIN)


def test_fit_with_multidataset_metrics_and_listeners(tmp_path):
    from deeplearning4j_tpu_torch.common.environment import environment
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    X, Y = _xy(32)
    sd = _regression(tsd, TSgd(0.05))
    hist_l = listeners.HistoryListener()
    ckpt = listeners.CheckpointListener(str(tmp_path / "ck"),
                                        save_every_n_epochs=1, keep_last=1)
    bench = listeners.OpBenchmarkListener()
    prof = listeners.ProfilingListener(str(tmp_path / "trace.json"))
    logs = []
    sd.add_listener(listeners.ScoreListener(frequency=1, log_fn=logs.append))
    reg = environment().metrics()
    steps = reg.counter("dl4j_train_steps_total", "Optimizer steps taken",
                        labels=("path",)).labels(path="samediff")
    before = steps.value()
    h = sd.fit([MultiDataSet([X[:16]], [Y[:16]]),
                MultiDataSet([X[16:]], [Y[16:]])], num_epochs=2,
               listeners=[hist_l, ckpt, bench, prof])
    assert h.iterations == 4 and len(hist_l.losses) == 4 and len(logs) == 4
    assert sd._last_batch_size == 16
    if reg.enabled:
        assert steps.value() == before + 4
    saved = os.listdir(tmp_path / "ck")
    assert saved == ["checkpoint_epoch1.zip"]
    assert len(bench.times) == 3 and os.path.exists(tmp_path / "trace.json")


# -- bucketed output ---------------------------------------------------------------

def test_bucketed_output_matches_exact():
    r = np.random.RandomState(3)
    sd = tsd()
    x = sd.placeholder("x", (None, 4))
    w = sd.var("w", r.randn(4, 3).astype(np.float32))
    y = sd.nn.softmax(x.mmul(w))
    xs = r.randn(5, 4).astype(np.float32)
    fn = sd.make_function([y.name], ("x",))
    padded, pad = sd._bucketable_padding(
        fn, {"x": torch.from_numpy(xs)}, [y.name])
    assert pad == (5, 8) and padded["x"].shape == (8, 4)
    got = sd.output({"x": xs}, [y])[y.name].numpy()
    want = torch.softmax(torch.from_numpy(xs) @ torch.from_numpy(
        sd.get_arr_for_var("w").numpy()), -1).numpy()
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got, want, **F32)


def test_batch_reducing_graph_falls_back_to_exact():
    sd = tsd()
    x = sd.placeholder("x", (None, 4))
    m = x.mean(0)            # reduces the batch: padding would change it
    t = x.transpose()        # moves the batch off axis 0
    xs = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    for v, want in ((m, xs.mean(0)), (t, xs.T)):
        fn = sd.make_function([v.name], ("x",))
        _, pad = sd._bucketable_padding(fn, {"x": torch.from_numpy(xs)},
                                        [v.name])
        assert pad is None
        np.testing.assert_allclose(sd.output({"x": xs}, [v])[v.name]
                                   .numpy(), want, **F32)
    # host-read control flow cannot be proved on meta tensors: exact
    p = sd.placeholder("p", ())
    c = sd.cond(p, lambda a: a * 2.0, lambda a: a, x)
    fn = sd.make_function([c.name], ("p", "x"))
    _, pad = sd._bucketable_padding(
        fn, {"x": torch.from_numpy(xs), "p": torch.tensor(True)}, [c.name])
    assert pad is None


# -- save / load across packages --------------------------------------------------

def _trained(mk, upd):
    X, Y = _xy(32)
    sd = _regression(mk, upd)
    sd.fit(_it(mk, X, Y, 16), num_epochs=2)
    return sd, X


@pytest.mark.parametrize("updater_state", [False, True])
def test_save_load_across_packages(tmp_path, updater_state):
    pred_of = lambda sd: [n for n in sd._vars if n.startswith("add")][0]  # noqa
    jsd_, X = _trained(jsd, JAdam(learning_rate=0.05))
    tsd_, _ = _trained(tsd, TAdam(learning_rate=0.05))
    # JAX -> port
    jp = str(tmp_path / "jax.sdz")
    jsd_.save(jp, save_updater_state=updater_state)
    t2 = TSameDiff.load(jp, device="cpu")
    out = pred_of(jsd_)
    np.testing.assert_allclose(
        t2.output({"x": X}, [out])[out].numpy(),
        np.asarray(jsd_.output({"x": X}, [out])[out].numpy()), **F32)
    if updater_state:
        for k in ("u", "m"):
            for n, a in jsd_._updater_state[k].items():
                np.testing.assert_array_equal(
                    t2._updater_state[k][n].numpy(), np.asarray(a))
    else:
        assert t2._updater_state is None
    # port -> JAX
    tp = str(tmp_path / "port.sdz")
    tsd_.save(tp, save_updater_state=updater_state)
    j2 = JSameDiff.load(tp)
    out = pred_of(tsd_)
    np.testing.assert_allclose(
        np.asarray(j2.output({"x": X}, [out])[out].numpy()),
        tsd_.output({"x": X}, [out])[out].numpy(), **F32)
    if updater_state:
        # the JAX loader keeps no updater state; its leaves are in the
        # zip in jax.tree_util order
        import io
        import jax
        import zipfile
        with zipfile.ZipFile(tp) as z:
            npz = np.load(io.BytesIO(z.read("arrays.npz")))
            n_upd = sum(1 for k in npz.files if k.startswith("__updater__"))
            leaves = [npz[f"__updater____SLASH__{i}"] for i in range(n_upd)]
        want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            np.asarray, bridge_state(tsd_)))
        for a, b in zip(leaves, want):
            np.testing.assert_array_equal(a, b)
        # and a state the port saved carries on training as the original
        t3 = TSameDiff.load(tp, device="cpu")
        Xn, Yn = _xy(16, seed=9)
        tsd_.fit(_it(tsd, Xn, Yn, 16))
        t3.fit(_it(tsd, Xn, Yn, 16))
        np.testing.assert_allclose(t3.get_arr_for_var("w").numpy(),
                                   tsd_.get_arr_for_var("w").numpy(), **F32)


def bridge_state(sd):
    return {k: {n: t.numpy() for n, t in v.items()}
            for k, v in sd._updater_state.items()}


def test_control_flow_and_sliced_graphs_roundtrip(tmp_path):
    r = np.random.RandomState(0)
    sd = tsd()
    x = sd.placeholder("x", (4, 6))
    p = sd.constant(np.asarray(False))
    c = sd.cond(p, lambda a: a * 10.0, lambda a: a * -1.0, x)
    w = sd.var("w", r.randn(6, 6).astype(np.float32))
    _, hs = sd.scan(lambda h, xt: (h + xt.mmul(w),) * 2,
                    init=[sd.constant(np.zeros(6, np.float32))], xs=[x])
    n = sd.placeholder("n", ())
    _, total = sd.while_loop(lambda i, s: i < n,
                             lambda i, s: (i + 1.0, s + i),
                             sd.constant(np.asarray(0.0, np.float32)),
                             sd.constant(np.asarray(0.0, np.float32)))
    out = (x[1:3, ::2] * 2.0).sum() + c.sum() + hs[::-1].sum() + total
    out.rename("out")
    path = str(tmp_path / "cf.sdz")
    sd.save(path)
    xs = np.arange(24, dtype=np.float32).reshape(4, 6) / 10
    ph = {"x": xs, "n": np.asarray(4.0, np.float32)}
    want = sd.output(ph, ["out"])["out"].numpy()
    np.testing.assert_allclose(
        TSameDiff.load(path, device="cpu").output(ph, ["out"])["out"].numpy(),
        want, **F32)
    np.testing.assert_allclose(
        np.asarray(JSameDiff.load(path).output(ph, ["out"])["out"].numpy()),
        want, atol=1e-4, rtol=1e-6)


def test_bf16_arrays_cross_as_the_jax_package_writes_them(tmp_path):
    """The JAX package writes a bf16 array as ``np.savez`` writes an
    ml_dtypes bf16 array (a 2-byte void record); the port reads it back as
    bf16, bit for bit, and writes it the same way. The JAX loader cannot
    read its own bf16 file (``jnp.asarray`` of a void array): pinned."""
    sd = jsd()
    w = sd.var("w", jnp.asarray([[1.5, -2.25], [0.1, 3.0]], jnp.bfloat16))
    x = sd.placeholder("x", (None, 2), dtype="bfloat16")
    y = x.mmul(w)
    path = str(tmp_path / "bf16.sdz")
    sd.save(path)
    t = TSameDiff.load(path, device="cpu")
    assert t._arrays["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t._arrays["w"].view(torch.int16).numpy(),
        np.asarray(sd._arrays["w"]).view(np.int16))
    got = t.output({"x": torch.ones(1, 2, dtype=torch.bfloat16)}, [y.name])
    assert got[y.name].torch().dtype == torch.bfloat16
    path2 = str(tmp_path / "bf16_port.sdz")
    t.save(path2)
    import io
    import zipfile
    for p in (path, path2):
        with zipfile.ZipFile(p) as z:
            a = np.load(io.BytesIO(z.read("arrays.npz")))["w"]
        assert a.dtype.kind == "V" and a.dtype.itemsize == 2
    with pytest.raises(TypeError):
        JSameDiff.load(path)


def test_bridge_load_samediff_and_device_rules():
    jsd_, X = _trained(jsd, JAdam(learning_rate=0.05))
    t = _regression(tsd, TAdam(learning_rate=0.05))
    bridge.load_samediff(
        t, {n: np.asarray(a) for n, a in jsd_._arrays.items()},
        {k: {n: np.asarray(a) for n, a in v.items()}
         for k, v in jsd_._updater_state.items()}, iteration=4)
    assert t._iteration == 4
    name = [n for n in t._vars if n.startswith("add")][0]
    np.testing.assert_allclose(
        t.output({"x": X}, [name])[name].numpy(),
        np.asarray(jsd_.output({"x": X}, [name])[name].numpy()), **F32)
    # placeholders as numpy / CPU tensors land on the graph's device;
    # host float64 narrows to float32 as jnp.asarray does
    r = t.output({"x": X.astype(np.float64)}, [name])[name].torch()
    assert r.dtype == torch.float32 and r.device.type == "cpu"


def test_entry_points_default_to_the_card():
    import inspect
    assert inspect.signature(TSameDiff.create).parameters["device"] \
        .default == "cuda"
    assert inspect.signature(TSameDiff.load).parameters["device"] \
        .default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default succeeds")
    with pytest.raises(RuntimeError, match="cuda"):
        TSameDiff.create()


def test_save_flatbuffers_and_raw_functions_refused(tmp_path):
    sd = tsd()
    x = sd.placeholder("x", (2,))
    y = sd._record_fn(lambda a: a * 2, [x], label="raw")
    with pytest.raises(ValueError, match="raw"):
        sd.save_flatbuffers(str(tmp_path / "g.fb"))
    with pytest.raises(ValueError, match="raw"):
        sd.save(str(tmp_path / "g.sdz"))
    np.testing.assert_allclose(
        y.eval({"x": np.ones(2, np.float32)}).numpy(), [2, 2])
    assert "SameDiff:" in sd.summary()
