"""The training census of the PyTorch port against the JAX package's.

Every compiled training function of the JAX package goes through
``counted_jit``, which records one ``dl4j_compiles_total`` event per new
input signature; the port's counterparts go through
``runtime.inference.counted_dispatch`` with the same tags. The same calls
on the same seeded batches must record the same number of events per
kind (the tag before its first ``:``) on both sides, and a repeat call
with the same signatures none:

- ``train`` / ``epoch``: ``fit`` of a ``MultiLayerNetwork`` and a
  ``ComputationGraph`` (the scanned epoch, the per-step path over two
  batch sizes);
- ``solver``: a line-search solver's loss and gradient;
- ``parallel`` / ``parallel_infer``: ``ParallelWrapper`` and
  ``ParallelInference`` on a one-device mesh;
- ``accum_grad`` / ``accum_apply``: ``fit_accumulated``;
- ``bert_train`` / ``bert_qa``: BERT tiny's scanned and QA steps.

Not held here: ``bert_pipeline``, whose step needs a pipe axis of two or
more ranks (``tests/test_torch_pipeline.py`` drives it on gloo rank
pools); the port wraps it the same way. ``warm_compile`` records one
``train`` event in the port and none in the JAX package, whose
``compile_cache.warm`` compiles a donated step without the census; it
is held in ``tests/test_torch_compile_cache.py``.
"""
import contextlib
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.learning as jlearn
import deeplearning4j_tpu.nn.conf.layers as JL
import deeplearning4j_tpu.nn.graph as JG
from deeplearning4j_tpu.common import mesh as jmesh
from deeplearning4j_tpu.common.environment import environment as jenv
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu.nn import solvers as jsolvers
from deeplearning4j_tpu.nn.conf.config import (InputType as JInputType,
                                               NeuralNetConfiguration as JNNC)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import accumulation as jacc
from deeplearning4j_tpu.parallel import trainer as jtrainer

import deeplearning4j_tpu_torch.learning as tlearn
import deeplearning4j_tpu_torch.nn.conf.layers as TL
import deeplearning4j_tpu_torch.nn.graph as TG
from deeplearning4j_tpu_torch.bridge import params_from_numpy
from deeplearning4j_tpu_torch.common.environment import environment as tenv
from deeplearning4j_tpu_torch.common.mesh import MeshConfig, make_mesh
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.learning import tree_map
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.nn import solvers as tsolvers
from deeplearning4j_tpu_torch.nn.conf.config import (InputType as TInputType,
                                                     NeuralNetConfiguration
                                                     as TNNC)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.parallel import accumulation as tacc
from deeplearning4j_tpu_torch.parallel import trainer as ttrainer

N_IN, N_OUT = 5, 3
JAX_NS = (JNNC, JL, JG, jlearn, JInputType)
TORCH_NS = (TNNC, TL, TG, tlearn, TInputType)


@contextlib.contextmanager
def events():
    """Events recorded on each side in the block, by kind."""
    got = {"jax": Counter(), "port": Counter()}

    def listener(side):
        return lambda key: got[side].update([str(key[0]).split(":")[0]])
    on = {"jax": listener("jax"), "port": listener("port")}
    jenv().add_compile_listener(on["jax"])
    tenv().add_compile_listener(on["port"])
    try:
        yield got
    finally:
        jenv().remove_compile_listener(on["jax"])
        tenv().remove_compile_listener(on["port"])


def _batches(sizes, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(n, N_IN).astype(np.float32),
             np.eye(N_OUT, dtype=np.float32)[rs.randint(0, N_OUT, n)])
            for n in sizes]


def _mlp(NNC, L, G, learning, InputType):
    return (NNC.builder().seed(0).updater(learning.Adam(1e-2)).list()
            .layer(L.DenseLayer(n_in=N_IN, n_out=8, activation="tanh"))
            .layer(L.OutputLayer(n_in=8, n_out=N_OUT))
            .build())


def _graph(NNC, L, G, learning, InputType):
    return (NNC.builder().seed(0).updater(learning.Adam(1e-2))
            .graph_builder()
            .add_inputs("in")
            .set_input_types(InputType.feed_forward(N_IN))
            .add_layer("d1", L.DenseLayer(n_in=N_IN, n_out=8,
                                          activation="relu"), "in")
            .add_layer("out", L.OutputLayer(n_in=8, n_out=N_OUT), "d1")
            .set_outputs("out")
            .build())


def _nets(kind):
    if kind == "graph":
        return (JG.ComputationGraph(_graph(*JAX_NS)).init(),
                TG.ComputationGraph(_graph(*TORCH_NS), device="cpu").init())
    return (JMLN(_mlp(*JAX_NS)).init(),
            TMLN(_mlp(*TORCH_NS), device="cpu").init())


def _fit(net, DataSet, batches):
    net.fit([DataSet(x, y) for x, y in batches])


# each call is (batch sizes of one fit, events of its kind it must add):
# a list of one shape is the scanned epoch, mixed shapes the per-step path
FIT_CALLS = [
    ((4, 4), {"epoch": 1}),
    ((4, 4), {}),                        # the same signature again
    ((4, 6, 4), {"train": 2}),           # the per-step path, two shapes
    ((6, 4), {}),
]


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_fit_records_the_jax_events_per_kind(kind):
    jnet, tnet = _nets(kind)
    for sizes, want in FIT_CALLS:
        batches = _batches(sizes, seed=len(sizes))
        with events() as got:
            _fit(jnet, JDataSet, batches)
            _fit(tnet, TDataSet, batches)
        assert got["port"] == got["jax"] == Counter(want), sizes


@pytest.fixture(scope="module")
def mlps():
    """One network pair for the tests below: each records kinds of its
    own, under tags of its own."""
    return _nets("multilayer")


def test_solver_records_one_event_per_network(mlps):
    jnet, tnet = mlps
    (x, y), = _batches((8,))
    with events() as got:
        for _ in range(2):
            jsolvers.LineGradientDescent(max_iterations=1).optimize(
                jnet, x, y)
            tsolvers.LineGradientDescent(max_iterations=1).optimize(
                tnet, x, y)
    assert got["port"] == got["jax"] == Counter({"solver": 1})


def test_parallel_wrapper_and_inference_on_one_device(mlps):
    jnet, tnet = mlps
    jm = jmesh.make_mesh(jmesh.MeshConfig(data=1),
                         devices=jax.devices()[:1])
    tm = make_mesh(MeshConfig(), device="cpu")
    batches = _batches((4, 4), seed=3)
    with events() as got:
        jtrainer.ParallelWrapper(jnet, jm, prefetch_buffer=0).fit(
            [JDataSet(x, y) for x, y in batches])
        ttrainer.ParallelWrapper(tnet, tm, prefetch_buffer=0).fit(
            [TDataSet(x, y) for x, y in batches])
        jinf = jtrainer.ParallelInference(jnet, jm)
        tinf = ttrainer.ParallelInference(tnet, tm)
        for n in (3, 3):
            x = batches[0][0][:n]
            np.testing.assert_allclose(tinf.output(x).numpy().shape,
                                       np.asarray(jinf.output(x).jax()).shape)
    assert got["port"] == got["jax"] == Counter({"parallel": 1,
                                                 "parallel_infer": 1})


def test_fit_accumulated_records_grad_and_apply(mlps):
    jnet, tnet = mlps
    batches = _batches((4, 4, 4, 4, 6), seed=5)
    with events() as got:
        jacc.fit_accumulated(jnet, batches, accumulation_steps=2)
        tacc.fit_accumulated(tnet, batches, accumulation_steps=2)
    assert got["port"] == got["jax"] == Counter({"accum_grad": 2,
                                                 "accum_apply": 1})


def _bert_configs():
    small = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
                 intermediate_size=64, max_position_embeddings=32)
    jc = dataclasses.replace(jb.BertConfig.tiny(), dtype=jnp.float32,
                             **small)
    tc = dataclasses.replace(tb.BertConfig.tiny(), dtype=torch.float32,
                             **small)
    return jc, tc


def _mlm_batch(T, seed=0):
    rs = np.random.RandomState(seed)
    labels = np.where(rs.rand(2, T) < 0.3, rs.randint(0, 128, (2, T)),
                      -100).astype(np.int32)
    labels[0, 0] = 3
    return {"input_ids": rs.randint(0, 128, (2, T)).astype(np.int32),
            "attention_mask": np.ones((2, T), np.int32), "labels": labels}


def _qa_batch(T, seed=0):
    rs = np.random.RandomState(seed)
    return {"input_ids": rs.randint(0, 128, (2, T)).astype(np.int32),
            "attention_mask": np.ones((2, T), np.int32),
            "start_positions": rs.randint(0, T, 2).astype(np.int32),
            "end_positions": rs.randint(0, T, 2).astype(np.int32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_bert_scanned_and_qa_steps():
    jc, tc = _bert_configs()
    # the port's init (the JAX package's layout), shared by both sides
    tree = tree_map(lambda t: t.numpy(),
                    tb.init_params(tc, seed=0, device="cpu"))
    qa = tree_map(lambda t: t.numpy(),
                  tb.init_qa_params(tc, seed=1, device="cpu"))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device="cpu")
    jstep = jb.make_scanned_train_step(jc, 2, remat=False)
    tstep = tb.make_scanned_train_step(tc, 2, remat=False)
    jo, to = jb.init_opt_state(jp), tb.init_opt_state(tp)
    with events() as got:
        for T in (8, 8):
            jbatch, tbatch = _both(_mlm_batch(T))
            jp, jo, jl = jstep(jp, jo, jbatch, 0)
            tp, to, tl = tstep(tp, to, tbatch, 0)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-4)
    assert got["port"] == got["jax"] == Counter({"bert_train": 1})
    jall = jax.tree_util.tree_map(jnp.asarray, {"bert": tree, "qa": qa})
    tall = params_from_numpy({"bert": tree, "qa": qa}, device="cpu")
    jqa, tqa = jb.make_qa_train_step(jc), tb.make_qa_train_step(tc)
    jqo, tqo = jb.init_opt_state(jall), tb.init_opt_state(tall)
    with events() as got:
        for i, T in enumerate((8, 8)):
            jbatch, tbatch = _both(_qa_batch(T, seed=i))
            jall, jqo, _ = jqa(jall, jqo, jbatch, i)
            tall, tqo, _ = tqa(tall, tqo, tbatch, i)
    assert got["port"] == got["jax"] == Counter({"bert_qa": 1})
