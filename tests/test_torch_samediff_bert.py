"""The slice as a whole: BERT-for-QA (BASELINE config 3's SQuAD fine-tune)
recorded as a SameDiff graph, on the port and on the JAX package, at a
tiny width (2 layers, hidden 32, 4 heads, T=16, B=4, f32).

The graph is built by ``chip_smoke.samediff_qa_graph``, the helper the
card's ``samediff_bert`` phase runs at full width, from either package's
``SameDiff``. The JAX graph's weights are drawn with numpy; the port's
graph is recorded over other weights and takes the JAX graph's through
``bridge.load_samediff``. Every port call runs on the CPU.

Tolerances, each with its reason:
- start / end logits, the loss and every gradient: atol 1e-5 plus rtol
  1e-5 (``F32``): 2 layers of f32 products and softmaxes summed in
  another order;
- the parameters after 3 ``fit`` steps of Adam at the fine-tune's
  learning rate, 5e-5: within 1e-5 (``F32``), but for the two weights
  whose gradient is zero in exact arithmetic: the span head's bias and
  the last layer's output layer-norm bias add one constant to every
  position's logit, which the softmax over positions cancels. Their f32
  gradients are rounding noise (~1e-9, of either sign on either side),
  and Adam scales noise up to a step of about lr, so they are held to
  6 * lr (``NOISE``), three steps of up to twice lr;
- the graph against ``models/bert.py``'s ``qa_logits`` / ``qa_loss`` at
  ``BertConfig`` f32: atol 1e-4 (``MODEL``): the model scales its
  attention logits by ``head_dim ** -0.5`` where the graph's
  ``dot_product_attention`` divides by ``sqrt(head_dim)``, and computes
  its products as einsums;
- the predict route and the engine against the JAX package's: 1e-5.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from deeplearning4j_tpu import serving as jserving
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff.training import TrainingConfig as JTC
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.runtime import inference as jinf

from deeplearning4j_tpu_torch import bridge
from deeplearning4j_tpu_torch import serving as tserving
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff as TSameDiff
from deeplearning4j_tpu_torch.autodiff.training import TrainingConfig as TTC
from deeplearning4j_tpu_torch.common.environment import environment
from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet as TMDS
from deeplearning4j_tpu_torch.learning import Adam as TAdam
from deeplearning4j_tpu_torch.runtime import inference as tinf

F32 = dict(atol=1e-5, rtol=1e-5)
MODEL = dict(atol=1e-4, rtol=1e-4)
NOISE = dict(atol=6 * chip_smoke.SD_LR, rtol=0)
DIMS = chip_smoke.qa_dims(hidden=32, layers=2, heads=4, ffn=64, vocab=100,
                          positions=32)
B, T = 4, 16
FEATURES = ["input_ids", "token_type_ids", "attention_mask"]
LABELS = ["start_positions", "end_positions"]


def _batch(seed=0, b=B):
    return chip_smoke.qa_batch(DIMS, b, T, seed=seed)


def _features(batch):
    return {k: batch[k] for k in FEATURES}


@pytest.fixture()
def pair():
    """(JAX graph, port graph on the CPU, output names), one set of
    weights."""
    jsd = JSameDiff.create()
    names = chip_smoke.samediff_qa_graph(jsd, chip_smoke.qa_weights(DIMS, 0),
                                         DIMS, T)
    tsd = TSameDiff.create(device="cpu")
    tnames = chip_smoke.samediff_qa_graph(
        tsd, chip_smoke.qa_weights(DIMS, 1), DIMS, T)
    assert names == tnames
    bridge.load_samediff(tsd, {n: np.asarray(a)
                               for n, a in jsd._arrays.items()})
    return jsd, tsd, names


def _np(x):
    return np.asarray(x.numpy())


def test_parameter_count_at_full_width_is_the_stated_one():
    d = chip_smoke.qa_dims()
    E, F, V = d["hidden"], d["ffn"], d["vocab"]
    emb = (V + d["positions"] + d["type_vocab"]) * E + 2 * E
    layer = 4 * (E * E + E) + 2 * E * F + F + E + 4 * E
    assert emb == 23_837_184 and layer == 7_087_872
    assert emb + d["layers"] * layer + 2 * E + 2 == chip_smoke.SD_PARAMS
    tsd = TSameDiff.create(device="cpu")
    chip_smoke.samediff_qa_graph(tsd, chip_smoke.qa_weights(DIMS), DIMS, T)
    small = (100 + 32 + 2) * 32 + 64 + 2 * (4 * (32 * 32 + 32) + 2 * 32 * 64
                                            + 64 + 32 + 128) + 66
    assert chip_smoke.qa_param_count(tsd) == small


def test_logits_and_loss_match_jax(pair):
    jsd, tsd, names = pair
    batch = _batch(0)
    j = jsd.output(batch, list(names))
    t = tsd.output(batch, list(names))
    for n in names:
        assert _np(t[n]).shape == np.asarray(j[n].numpy()).shape
        np.testing.assert_allclose(_np(t[n]), np.asarray(j[n].numpy()),
                                   **F32)
    assert _np(t[names[0]]).shape == (B, T)


def test_every_gradient_matches_jax(pair):
    jsd, tsd, names = pair
    batch = _batch(1)
    wrt = [v.name for v in tsd.trainable_variables()]
    jg = jsd.calculate_gradients(batch, wrt, names[2])
    tg = tsd.calculate_gradients(batch, wrt, names[2])
    assert len(wrt) == 5 + 16 * DIMS["layers"] + 2
    for n in wrt:
        np.testing.assert_allclose(_np(tg[n]), np.asarray(jg[n].numpy()),
                                   err_msg=n, **F32)


def _jax_params(jsd):
    """The JAX graph's weights in models/bert.py's layout."""
    a = {n: np.asarray(v) for n, v in jsd._arrays.items()}
    E, H = DIMS["hidden"], DIMS["heads"]
    Dh = E // H
    params = {"embeddings": {"word": a["emb/word"], "position": a["emb/pos"],
                             "token_type": a["emb/type"],
                             "ln_g": a["emb/ln_g"], "ln_b": a["emb/ln_b"]},
              "layers": []}
    for i in range(DIMS["layers"]):
        p = f"l{i}/"
        attn = {f"w{n}": a[p + "w" + n].reshape(E, H, Dh) for n in "qkv"}
        attn.update({f"b{n}": a[p + "b" + n].reshape(H, Dh) for n in "qkv"})
        attn["wo"] = a[p + "wo"].reshape(H, Dh, E)
        attn["bo"] = a[p + "bo"]
        params["layers"].append({
            "attn": attn,
            "mlp": {k: a[p + k] for k in ("w1", "b1", "w2", "b2")},
            **{k: a[p + k] for k in ("ln1_g", "ln1_b", "ln2_g", "ln2_b")}})
    qa = {"w": a["qa/w"], "b": a["qa/b"]}
    return jax.tree_util.tree_map(jnp.asarray, params), \
        jax.tree_util.tree_map(jnp.asarray, qa)


def test_the_graph_is_the_models_qa_head(pair):
    """The graph against models/bert.py's qa_logits and qa_loss on the
    same weights at BertConfig f32: the graph is the model, not an
    approximation of it."""
    jsd, tsd, names = pair
    cfg = jbert.BertConfig(vocab_size=DIMS["vocab"],
                           hidden_size=DIMS["hidden"],
                           num_layers=DIMS["layers"],
                           num_heads=DIMS["heads"],
                           intermediate_size=DIMS["ffn"],
                           max_position_embeddings=DIMS["positions"],
                           type_vocab_size=DIMS["type_vocab"],
                           layer_norm_eps=DIMS["eps"], dtype=jnp.float32)
    params, qa = _jax_params(jsd)
    batch = _batch(2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    start, end = jbert.qa_logits(params, qa, jb, cfg)
    loss = jbert.qa_loss(params, qa, jb, cfg)
    got = tsd.output(batch, list(names))
    np.testing.assert_allclose(_np(got[names[0]]), np.asarray(start), **MODEL)
    np.testing.assert_allclose(_np(got[names[1]]), np.asarray(end), **MODEL)
    np.testing.assert_allclose(_np(got[names[2]]), np.asarray(loss), **MODEL)


def test_three_adam_steps_match_jax(pair):
    jsd, tsd, names = pair
    batches = [_batch(10 + i) for i in range(3)]
    for sd, cfg, adam, mds in ((jsd, JTC, JAdam, JMDS),
                               (tsd, TTC, TAdam, TMDS)):
        sd.set_training_config(cfg(
            updater=adam(learning_rate=chip_smoke.SD_LR),
            data_set_feature_mapping=FEATURES,
            data_set_label_mapping=LABELS))
        h = sd.fit([mds([b[k] for k in FEATURES], [b[k] for k in LABELS])
                    for b in batches], num_epochs=1)
        assert h.iterations == 3
        sd._hist = [float(v) for v in h.loss_curves[0].losses]
    np.testing.assert_allclose(tsd._hist, jsd._hist, **F32)
    noise = ("qa/b", f"l{DIMS['layers'] - 1}/ln2_b")
    for n, a in jsd._arrays.items():
        np.testing.assert_allclose(tsd._arrays[n].numpy(), np.asarray(a),
                                   err_msg=n,
                                   **(NOISE if n in noise else F32))
    for k in ("u", "m"):
        for n, a in jsd._updater_state[k].items():
            if n not in noise:
                np.testing.assert_allclose(
                    tsd._updater_state[k][n].numpy(), np.asarray(a),
                    atol=1e-7, rtol=1e-4, err_msg=f"{k}/{n}")


def test_bucketed_output_matches_exact_and_counts_once(pair):
    _, tsd, names = pair
    batch = _features(_batch(3, b=3))
    fn = tsd.make_function(names[:2], tuple(sorted(batch)))
    ph = {k: torch.from_numpy(v) for k, v in batch.items()}
    padded, pad = tsd._bucketable_padding(fn, ph, list(names[:2]))
    assert pad == (3, 4)
    got = tsd.output(batch, list(names[:2]))
    env = environment()
    env.set_inference_bucketing(False)
    try:
        exact = tsd.output(batch, list(names[:2]))
    finally:
        env.set_inference_bucketing(True)
    for n in names[:2]:
        assert _np(got[n]).shape == (3, T)
        np.testing.assert_allclose(_np(got[n]), _np(exact[n]), **F32)
    before = env.compile_count()
    tsd.output(_features(_batch(4, b=3)), list(names[:2]))
    assert env.compile_count() == before   # the same padded signature
    # the loss reduces the batch: its output is never padded
    _, pad = tsd._bucketable_padding(
        tsd.make_function([names[2]], tuple(sorted(_batch(3, b=3)))),
        {k: torch.from_numpy(v) for k, v in _batch(3, b=3).items()},
        [names[2]])
    assert pad is None


def test_inference_engine_matches_jax(pair):
    jsd, tsd, names = pair
    outs = list(names[:2])
    je = jinf.InferenceEngine(jsd, outputs=outs, max_batch=8)
    te = tinf.InferenceEngine(tsd, outputs=outs, max_batch=8)
    try:
        assert te.warmup(_features(_batch(5, b=1))) == [1, 2, 4, 8]
        for n in (1, 3, 8, 11):
            req = _features(_batch(20 + n, b=n))
            j, t = je.infer(req), te.infer(req)
            assert set(t) == set(outs)
            for o in outs:
                assert _np(t[o]).shape == (n, T)
                np.testing.assert_allclose(_np(t[o]),
                                           np.asarray(j[o].numpy()), **F32)
        fut = te.submit(_features(_batch(30, b=2)))
        res = fut.result(timeout=60)
        np.testing.assert_allclose(
            _np(res[outs[0]]),
            np.asarray(je.infer(_features(_batch(30, b=2)))[outs[0]]
                       .numpy()), **F32)
        with pytest.raises(TypeError, match="placeholder dicts"):
            te.infer(_batch(0)["input_ids"])
        # ported: the adapter stores its arrays under a spec and gathers
        # them at use (a 1x1 mesh here; two ranks in
        # test_torch_sharded_serving.py)
        from deeplearning4j_tpu_torch.common.mesh import serving_mesh
        te._adapter.shard(serving_mesh(device="cpu"), None)
        assert set(te._adapter.live()) == set(te._adapter.own())
    finally:
        je.close(0.0)
        te.close(0.0)


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
        return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_registry_deploy_and_predict_over_http_match_jax(pair):
    """``ModelRegistry.deploy(..., outputs=[...])`` and ``POST
    /v1/models/<name>/predict`` with a placeholder dict: the port answers
    as the JAX server does on the same body."""
    jsd, tsd, names = pair
    outs = list(names[:2])
    servers = {}
    try:
        for side, pkg, sd in (("jax", jserving, jsd),
                              ("torch", tserving, tsd)):
            reg = pkg.ModelRegistry(manifest_dir=None)
            mv = reg.deploy("qa", "v1", sd, outputs=outs,
                            example=_features(_batch(6, b=1)), max_batch=4)
            assert mv.state == "ready"
            srv = pkg.ModelServer(reg)
            servers[side] = (reg, srv, f"http://127.0.0.1:{srv.start()}")
        body = {"inputs": {k: v.tolist()
                           for k, v in _features(_batch(7, b=3)).items()}}
        docs = {}
        for side, (_, _, base) in servers.items():
            status, raw = _post(base + "/v1/models/qa/predict", body)
            assert status == 200, (side, raw)
            docs[side] = json.loads(raw)
        assert docs["torch"]["version"] == docs["jax"]["version"] == "v1"
        assert set(docs["torch"]["outputs"]) == set(outs)
        for o in outs:
            t = np.asarray(docs["torch"]["outputs"][o], np.float32)
            assert t.shape == (3, T)
            np.testing.assert_allclose(
                t, np.asarray(docs["jax"]["outputs"][o], np.float32), **F32)
            np.testing.assert_allclose(
                t, _np(tsd.output(_features(_batch(7, b=3)), [o])[o]), **F32)
    finally:
        for reg, srv, _ in servers.values():
            srv.stop()
            reg.drain_all(timeout_s=10, save_manifests=False)
