"""The port's layer-API parallelism against single-process ``fit`` and
the JAX package (``parallel/trainer.py``, ``accumulation.py``,
``fault_tolerance.py``, ``spark_compat.py``, ``nn/sharding.py``,
``nn/checkpoint.py`` across meshes).

A small CNN with batch norm (3 batches of 8, Adam lr 1e-3) trains on 4
gloo ranks through ``ParallelWrapper`` (with and without ZeRO-1) and
through ``distribute`` on data=2 x tensor=2; the references are the
port's single-process ``fit`` from the same bridged weights (the batch
norm statistics must be the global batch's for these to agree) and the
JAX package's ``ParallelWrapper`` / ``distribute`` on 4 virtual CPU
devices.

Tolerances: against the single-process fit, the same f32 ops with the
batch sums taken over ranks, atol 1e-6 (params, running stats, Adam
state); against JAX, as ``test_torch_multilayer.py`` holds 3 Adam steps,
atol 0.1 * lr on params and 1e-5 on running stats and losses.
"""
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.learning as jlearn
import deeplearning4j_tpu.nn.conf.layers as JL
import deeplearning4j_tpu.nn.graph as JG
from deeplearning4j_tpu.common import mesh as jmesh
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf.config import (InputType as JInputType,
                                               NeuralNetConfiguration as JNNC)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import accumulation as jacc
from deeplearning4j_tpu.parallel import fault_tolerance as jft
from deeplearning4j_tpu.parallel import spark_compat as jspark
from deeplearning4j_tpu.parallel import trainer as jtrainer

from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch.common.mesh import MeshConfig, make_mesh
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn.conf.config import \
    MultiLayerConfiguration as TConf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.parallel import accumulation as tacc
from deeplearning4j_tpu_torch.parallel import fault_tolerance as tft
from deeplearning4j_tpu_torch.parallel import spark_compat as tspark

from torch_parallel_cases import Ranks

LR = 1e-3
EXACT = 1e-6


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(4)
    yield r
    r.close()


def cnn_bn(NNC, L, learning, InputType):
    return (NNC.builder().seed(3).updater(learning.Adam(LR)).list()
            .layer(L.ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                      stride=(2, 2), convolution_mode="same",
                                      activation="relu"))
            .layer(L.BatchNormalization())
            .layer(L.DenseLayer(n_out=16, activation="gelu"))
            .layer(L.OutputLayer(n_out=3))
            .set_input_type(InputType.convolutional(9, 9, 2))
            .build())


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def cnn():
    jconf = cnn_bn(JNNC, JL, jlearn, JInputType)
    params = np_tree(JMLN(jconf).init()._params)
    rs = np.random.RandomState(0)
    xs = [rs.randn(8, 2, 9, 9).astype(np.float32) for _ in range(3)]
    ys = [np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
          for _ in range(3)]
    return jconf, params, xs, ys


def jax_net(jconf, params):
    return JMLN(jconf).init(params=jax.tree_util.tree_map(jnp.asarray,
                                                          params))


def assert_layers(got, want, atol, stats_atol=None):
    for g, w in zip(got, want):
        for k in g:
            tol = stats_atol if (stats_atol is not None
                                 and k.startswith("state_")) else atol
            np.testing.assert_allclose(g[k], np.asarray(w[k], np.float32),
                                       atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("zero1", [False, True])
def test_parallel_wrapper_matches_fit_and_jax(ranks, cnn, zero1):
    jconf, params, xs, ys = cnn
    got, ref, u_got, u_ref, s_got, s_ref = ranks.run(
        "parallel_wrapper", jconf.to_json(), params, xs, ys, zero1,
        {"data": 4})[0]
    assert_layers(got, ref, EXACT)
    for a, b in zip(u_got, u_ref):
        np.testing.assert_allclose(a, b, atol=EXACT, rtol=0)
    assert s_got == pytest.approx(s_ref, abs=EXACT)
    jnet = jax_net(jconf, params)
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=4),
                           devices=jax.devices()[:4])
    jtrainer.ParallelWrapper(jnet, mesh, prefetch_buffer=0,
                             zero1=zero1).fit(
        [JDataSet(x, y) for x, y in zip(xs, ys)])
    assert_layers(got, np_tree(jnet._params), 0.1 * LR, 1e-5)
    assert s_got == pytest.approx(float(jnet.score_value), abs=1e-5)


def test_parallel_wrapper_honours_grad_accum_and_remat(ranks, cnn):
    """conf.grad_accum = 2 (each global batch cut into 2 micro-batches
    before it is sharded, as the JAX step cuts it) and conf.remat =
    "layer": the wrapper's step is the fit step's."""
    jconf = (JNNC.builder().seed(3).updater(jlearn.Adam(LR))
             .grad_accum(2).remat("layer").list()
             .layer(JL.ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                        stride=(2, 2),
                                        convolution_mode="same",
                                        activation="relu"))
             .layer(JL.BatchNormalization())
             .layer(JL.DenseLayer(n_out=16, activation="gelu"))
             .layer(JL.OutputLayer(n_out=3))
             .set_input_type(JInputType.convolutional(9, 9, 2))
             .build())
    _, params, xs, ys = cnn
    got, ref, u_got, u_ref, s_got, s_ref = ranks.run(
        "parallel_wrapper", jconf.to_json(), params, xs, ys, False,
        {"data": 4})[0]
    assert_layers(got, ref, EXACT)
    assert s_got == pytest.approx(s_ref, abs=EXACT)


def test_zero1_layout_is_the_leading_dim(ranks):
    from deeplearning4j_tpu_torch.common.mesh import P, zero1_spec
    m = make_mesh(MeshConfig(data=4), devices=range(4), device="cpu")
    assert zero1_spec(m, np.zeros((16, 3))) == P(("data", "fsdp"))
    assert zero1_spec(m, np.zeros((6, 4))) == P()


def test_distribute_multilayer_matches_fit(ranks, cnn):
    jconf, params, xs, ys = cnn
    got, ref, out, out_ref, shapes = ranks.run(
        "distribute_mln", jconf.to_json(), params, xs, ys,
        {"data": 2, "tensor": 2})[0]
    assert_layers(got, ref, EXACT)
    np.testing.assert_allclose(out, out_ref, atol=EXACT, rtol=0)
    # the conv kernel's out-channels and the dense W's columns are sharded
    assert (3, 3, 2, 3) in shapes and (150, 8) in shapes


def graph_conf(NNC, L, learning, InputType):
    return (NNC.builder().seed(7).updater(learning.Adam(LR))
            .graph_builder()
            .add_inputs("in")
            .set_input_types(InputType.feed_forward(6))
            .add_layer("d1", L.DenseLayer(n_in=6, n_out=8,
                                          activation="relu"), "in")
            .add_layer("bn", L.BatchNormalization(n_out=8), "d1")
            .add_layer("out", L.OutputLayer(n_in=8, n_out=3), "bn")
            .set_outputs("out")
            .build())


def test_distribute_graph_matches_fit(ranks):
    jconf = graph_conf(JNNC, JL, jlearn, JInputType)
    params = np_tree(JG.ComputationGraph(jconf).init()._params)
    rs = np.random.RandomState(4)
    xs = [rs.randn(8, 6).astype(np.float32) for _ in range(2)]
    ys = [np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
          for _ in range(2)]
    got, ref, out, out_ref = ranks.run(
        "distribute_graph", jconf.to_json(), params, xs, ys,
        {"data": 2, "tensor": 2})[0]
    for n in got:
        assert_layers([got[n]], [ref[n]], EXACT)
    np.testing.assert_allclose(out, out_ref, atol=EXACT, rtol=0)


def test_parallel_inference_pads_and_trims(ranks, cnn):
    jconf, params, xs, _ = cnn
    got, direct = ranks.run("parallel_inference", jconf.to_json(), params,
                            xs[0][:7])[0]
    assert got.shape == (7, 3)
    np.testing.assert_allclose(got, direct, atol=EXACT, rtol=0)
    jnet = jax_net(jconf, params)
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=4),
                           devices=jax.devices()[:4])
    want = np.asarray(jtrainer.ParallelInference(jnet, mesh).output(
        xs[0][:7]).jax())
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("threshold", [None, 1e-3])
def test_fit_accumulated_matches_jax(cnn, threshold):
    jconf, params, xs, ys = cnn
    rs = np.random.RandomState(9)
    xs = xs + [rs.randn(8, 2, 9, 9).astype(np.float32) for _ in range(2)]
    ys = ys + [np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
               for _ in range(2)]
    jnet = jax_net(jconf, params)
    want = jacc.fit_accumulated(jnet, [JDataSet(x, y) for x, y in
                                       zip(xs, ys)], 2, threshold)
    tnet = bridge.load_multilayer(
        TMLN(TConf.from_json(jconf.to_json()), device="cpu"), params)
    got = tacc.fit_accumulated(tnet, [TDataSet(x, y) for x, y in
                                      zip(xs, ys)], 2, threshold)
    assert len(got) == len(want) == 3      # 2 + 2 + the trailing 1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert_layers([{k: v.numpy() for k, v in p.items()}
                   for p in tnet._params], np_tree(jnet._params),
                  0.1 * LR if threshold is None else 1e-5, 1e-5)


def test_gradients_accumulator_threshold_round_trip():
    import torch
    g = {"w": np.array([[0.5, -2e-3], [1e-4, -1.0]], np.float32)}
    jacc_ = jacc.GradientsAccumulator(threshold=1e-3)
    tacc_ = tacc.GradientsAccumulator(threshold=1e-3)
    for k in range(2):
        jacc_.store_update(jax.tree_util.tree_map(jnp.asarray, g))
        tacc_.store_update({"w": torch.from_numpy(g["w"] * 1)})
    np.testing.assert_allclose(tacc_.get_average()["w"].numpy(),
                               np.asarray(jacc_.get_average()["w"]))
    assert tacc_.count == jacc_.count == 2
    tacc_.reset()
    with pytest.raises(ValueError, match="no updates"):
        tacc_.get_average()


def test_fault_tolerant_trainer_resumes_on_a_rebuilt_mesh(ranks, cnn,
                                                          tmp_path):
    jconf, params, xs, ys = cnn
    got, ref, restarts, before, after, epoch, it, it_ref = ranks.run(
        "fault_tolerant", str(tmp_path), jconf.to_json(), params, xs, ys,
        1)[0]
    assert restarts == ["injected failure"]
    # tensor=3 does not divide 4 ranks: pure data parallelism, as JAX
    assert before == after == {"data": 4, "fsdp": 1, "tensor": 1, "seq": 1,
                               "pipe": 1}
    assert epoch == 3 and it == it_ref
    assert_layers(got, ref, EXACT)


@pytest.mark.parametrize("cfg", [dict(tensor=3), dict(tensor=2),
                                 dict(fsdp=2, tensor=2), dict(seq=8)],
                         ids=str)
def test_rebuild_mesh_matches_jax(cfg):
    for n in (4, 6):
        j = jft.rebuild_mesh(jmesh.MeshConfig(**cfg), jax.devices()[:n])
        t = tft.rebuild_mesh(MeshConfig(**cfg), range(n), device="cpu")
        assert t.shape == dict(j.shape)


@pytest.mark.parametrize("save_axes,load_axes", [
    ({"data": 2, "tensor": 2}, {"fsdp": 2, "tensor": 2}),
    ({"fsdp": 4}, {"tensor": 4}),
    ({"data": 2, "tensor": 2}, None)], ids=["dp2tp2-fsdp2tp2",
                                            "fsdp4-tp4", "dp2tp2-none"])
def test_checkpoint_restores_across_meshes(ranks, tmp_path, save_axes,
                                           load_axes):
    from deeplearning4j_tpu.models import bert as jb
    c = jb.BertConfig.tiny()
    c.dtype = jnp.float32
    params = np_tree(jb.init_params(jax.random.key(0), c))
    out = ranks.run("save_restore", str(tmp_path), params, save_axes,
                    load_axes, 7)
    got, u0, note, local = out[0]
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(g), w)
    np.testing.assert_array_equal(u0, np.full(u0.shape, 1.5, np.float32))
    assert note == "x"
    if load_axes is not None:
        # the restored leaves are the target mesh's shards
        assert any(tuple(w.shape) != loc for loc, w in zip(
            local, jax.tree_util.tree_leaves(params)))


def test_spark_masters_warn_per_inert_knob_as_jax(caplog):
    masters = [
        (jspark.ParameterAveragingTrainingMaster.Builder(8)
         .averaging_frequency(5).aggregation_depth(3).build(),
         tspark.ParameterAveragingTrainingMaster.Builder(8)
         .averaging_frequency(5).aggregation_depth(3).build()),
        (jspark.SharedTrainingMaster.Builder(8).update_threshold(1e-2)
         .threshold_algorithm("adaptive").residual_post_processor("p")
         .workers_per_node(2).build(),
         tspark.SharedTrainingMaster.Builder(8).update_threshold(1e-2)
         .threshold_algorithm("adaptive").residual_post_processor("p")
         .workers_per_node(2).build())]
    for jm, tm in masters:
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            jspark._warn_inert(jm)
        want = [r.getMessage() for r in caplog.records]
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            tspark._warn_inert(tm)
        got = [r.getMessage() for r in caplog.records]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.split(" has no effect")[0] == w.split(
                " has no effect")[0]
            assert "on this card" in g


def test_spark_multilayer_fits_on_a_one_rank_mesh(cnn):
    jconf, params, xs, ys = cnn
    net = bridge.load_multilayer(
        TMLN(TConf.from_json(jconf.to_json()), device="cpu"), params)
    ref = bridge.load_multilayer(
        TMLN(TConf.from_json(jconf.to_json()), device="cpu"), params)
    spark = tspark.SparkDl4jMultiLayer(
        make_mesh(MeshConfig(), device="cpu"), net,
        tspark.ParameterAveragingTrainingMaster.Builder(8).build())
    spark.fit([(x, y) for x, y in zip(xs, ys)])
    for x, y in zip(xs, ys):
        ref.fit(TDataSet(x, y))
    assert spark.get_score() == pytest.approx(ref.score_value, abs=EXACT)
    np.testing.assert_allclose(net.params().numpy(), ref.params().numpy(),
                               atol=EXACT, rtol=0)
