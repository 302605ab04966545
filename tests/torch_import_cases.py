"""Model-import cases shared by the port's import tests and
``chip_smoke.py``: the BERT GraphDef skeletons, their seeded filler, and
two ONNX graphs written with the port's ``protoio.Writer``.

A skeleton is the TF1 BERT encoder of ``tests/test_modelimport.py::
build_tf1_bert`` as a frozen GraphDef with the ``tensor_content`` of
every float constant over 4 KiB stripped (the weights; layer-norm scales
and biases stay). :func:`fill_graphdef` writes seeded float32 values back
into each stripped constant, so the full-width graph (440 MB of weights)
travels as a 0.4 MB file. Nothing here imports TensorFlow or JAX at
import time; only :func:`make_skeleton`, which writes the skeletons, runs
TF (``python tests/torch_import_cases.py`` rewrites both files).
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Tuple

import numpy as np

from deeplearning4j_tpu_torch.modelimport import protoio as pio
from deeplearning4j_tpu_torch.modelimport.tf.parser import parse_tensor_shape

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_data")
STRIP_BYTES = 4096
DT_FLOAT = 1

#: the two skeletons: BERT-base (``test_bert_base_full_size_golden``'s
#: widths) and ``test_bert_golden``'s tiny width; T is fixed in the graph,
#: the batch is not
BERT = {
    "base": dict(seq=128, hidden=768, n_layers=12, heads=12, vocab=30522,
                 intermediate=3072, max_pos=512),
    "tiny": dict(seq=16, hidden=64, n_layers=2, heads=4, vocab=99,
                 intermediate=128, max_pos=64),
}
INPUTS = ("input_ids", "input_mask", "token_type_ids")


def bert_params(name: str) -> int:
    """The float parameters of a skeleton's graph: embeddings, layers
    (q, k, v, output, two layer norms, the feed-forward pair) and the
    pooler."""
    w = BERT[name]
    H, inter = w["hidden"], w["intermediate"]
    layer = 4 * (H * H + H) + 2 * 2 * H + H * inter + inter + inter * H + H
    return ((w["vocab"] + 2 + w["max_pos"] + 2) * H + w["n_layers"] * layer
            + H * H + H)


BERT_BASE_PARAMS = bert_params("base")
OUTPUTS = ("sequence_output", "pooled_output")


def skeleton_path(name: str) -> str:
    return os.path.join(DATA, f"bert_{name}_skeleton.pb")


def read_skeleton(name: str) -> bytes:
    with open(skeleton_path(name), "rb") as f:
        return f.read()


def make_skeleton(name: str) -> bytes:
    """The named skeleton, built with TF (imported here, lazily)."""
    from test_modelimport import build_tf1_bert
    w = dict(BERT[name])
    g, _ = build_tf1_bert(1, w.pop("seq"), **w)
    gd = g.as_graph_def()
    for node in gd.node:
        if node.op == "Const":
            t = node.attr["value"].tensor
            if t.dtype == DT_FLOAT and len(t.tensor_content) > STRIP_BYTES:
                t.ClearField("tensor_content")
    return gd.SerializeToString(deterministic=True)


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes, bytes]]:
    """Each field of one message: (number, wire type, the field's bytes,
    its payload for a length-delimited field, else b"")."""
    pos = 0
    while pos < len(buf):
        start = pos
        key, pos = pio._read_varint(buf, pos)
        wtype = key & 7
        payload = b""
        if wtype == pio.VARINT:
            _, pos = pio._read_varint(buf, pos)
        elif wtype == pio.LENGTH:
            n, pos = pio._read_varint(buf, pos)
            payload = buf[pos:pos + n]
            pos += n
        elif wtype == pio.FIXED32:
            pos += 4
        elif wtype == pio.FIXED64:
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield key >> 3, wtype, buf[start:pos], payload


def _stripped_shape(tensor: bytes):
    """The shape of a float TensorProto with no values (a stripped
    weight), else None."""
    f = pio.decode(tensor)
    if pio.first(f, 1, 0) != DT_FLOAT or 4 in f or 5 in f or 2 not in f:
        return None
    shape = parse_tensor_shape(pio.first(f, 2))
    return shape if shape and int(np.prod(shape)) > 1 else None


def _filled_node(node: bytes, rng, scale: float):
    parts, changed = [], False
    for num, _, raw, payload in _fields(node):
        if num == 5:       # one attr map entry: key=1, AttrValue=2
            entry = pio.decode(payload)
            if pio.as_str(pio.first(entry, 1)) == "value":
                tensor = pio.first(pio.decode(pio.first(entry, 2)), 8)
                shape = _stripped_shape(tensor) if tensor else None
                if shape is not None:
                    vals = rng.standard_normal(int(np.prod(shape)),
                                               dtype=np.float32) * scale
                    filled = tensor + pio.Writer().bytes_(
                        4, vals.astype("<f4").tobytes()).build()
                    raw = pio.Writer().msg(5, pio.Writer().str_(
                        1, "value").msg(2, pio.Writer().bytes_(
                            8, filled))).build()
                    changed = True
        parts.append(raw)
    return b"".join(parts) if changed else None


def fill_graphdef(skeleton: bytes, seed: int = 0,
                  scale: float = 0.02) -> bytes:
    """The skeleton with each stripped constant given seeded float32
    values (standard normal times ``scale``, ``build_tf1_bert``'s), in
    node order."""
    rng = np.random.default_rng(seed)
    out = []
    for num, _, raw, payload in _fields(skeleton):
        if num == 1:       # GraphDef.node
            f = pio.decode(payload)
            if pio.as_str(pio.first(f, 2)) == "Const":
                node = _filled_node(payload, rng, scale)
                if node is not None:
                    raw = pio.Writer().bytes_(1, node).build()
        out.append(raw)
    return b"".join(out)


def bert_graph(name: str, seed: int = 0) -> bytes:
    return fill_graphdef(read_skeleton(name), seed)


def bert_feeds(name: str, batch: int, masked: int, seed: int = 7
               ) -> Dict[str, np.ndarray]:
    """Token ids, a mask zeroing the last ``masked`` positions and zero
    token types, each ``[batch, T]`` int32."""
    T, vocab = BERT[name]["seq"], BERT[name]["vocab"]
    rs = np.random.RandomState(seed)
    mask = np.ones((batch, T), np.int32)
    mask[:, T - masked:] = 0
    return {"input_ids": rs.randint(0, vocab, (batch, T)).astype(np.int32),
            "input_mask": mask,
            "token_type_ids": np.zeros((batch, T), np.int32)}


# ---------------------------------------------------------------- ONNX
def _onnx_tensor(name, arr):
    w = pio.Writer()
    for d in arr.shape:
        w.int_(1, d)
    w.int_(2, 1)  # FLOAT
    w.str_(8, name)
    w.bytes_(9, arr.astype("<f4").tobytes())
    return w


def _onnx_vi(name, shape):
    dimw = pio.Writer()
    for d in shape:
        dimw.msg(1, pio.Writer().int_(1, d))
    tens = pio.Writer().int_(1, 1).msg(2, dimw)
    return pio.Writer().str_(1, name).msg(2, pio.Writer().msg(1, tens))


def _onnx_node(op_type, inputs, outputs, **attrs):
    w = pio.Writer()
    for i in inputs:
        w.str_(1, i)
    for o in outputs:
        w.str_(2, o)
    w.str_(4, op_type)
    for k, v in attrs.items():
        aw = pio.Writer().str_(1, k)
        if isinstance(v, float):
            aw.int_(20, 1).float_(2, v)
        elif isinstance(v, int):
            aw.int_(20, 2).int_(3, v)
        else:
            aw.int_(20, 7)
            for x in v:
                aw.int_(8, x)
        w.msg(5, aw)
    return w


def _onnx_model(name, nodes, tensors, inputs, outputs):
    gw = pio.Writer()
    for n in nodes:
        gw.msg(1, n)
    gw.str_(2, name)
    for tname, arr in tensors.items():
        gw.msg(5, _onnx_tensor(tname, arr))
    for vname, shape in inputs:
        gw.msg(11, _onnx_vi(vname, shape))
    for vname, shape in outputs:
        gw.msg(12, _onnx_vi(vname, shape))
    model = pio.Writer().int_(1, 8).msg(7, gw)
    model.msg(8, pio.Writer().str_(1, "").int_(2, 17))
    return model.build()


def onnx_mlp(rs, batch=4):
    """``tests/test_modelimport.py::build_onnx_mlp``: MatMul-Add-Relu-
    MatMul-Softmax, x ``[batch, 8]`` -> y ``[batch, 3]``."""
    w1 = rs.randn(8, 16).astype(np.float32)
    b1 = rs.randn(16).astype(np.float32)
    w2 = rs.randn(16, 3).astype(np.float32)
    nodes = [_onnx_node("MatMul", ["x", "w1"], ["h0"]),
             _onnx_node("Add", ["h0", "b1"], ["h1"]),
             _onnx_node("Relu", ["h1"], ["h2"]),
             _onnx_node("MatMul", ["h2", "w2"], ["h3"]),
             _onnx_node("Softmax", ["h3"], ["y"], axis=-1)]
    data = _onnx_model("mlp", nodes, {"w1": w1, "b1": b1, "w2": w2},
                       [("x", (batch, 8))], [("y", (batch, 3))])
    return data, (w1, b1, w2)


def onnx_residual_block(rs, C=8, B=2, side=12, classes=5):
    """``TestOnnxResNetBlock``'s graph: Conv-BN-Relu-Conv-BN-Add-Relu-
    GAP-Flatten-Gemm, x ``[B, C, side, side]`` -> y ``[B, classes]``.
    Returns the model and its tensors by name."""
    tensors = {"w1": (rs.randn(C, C, 3, 3) * 0.2).astype(np.float32),
               "w2": (rs.randn(C, C, 3, 3) * 0.2).astype(np.float32),
               "fcw": (rs.randn(classes, C) * 0.3).astype(np.float32),
               "fcb": rs.randn(classes).astype(np.float32)}
    for i in (1, 2):
        tensors.update({f"s{i}": rs.rand(C).astype(np.float32) + 0.5,
                        f"bb{i}": rs.randn(C).astype(np.float32) * 0.1,
                        f"m{i}": rs.randn(C).astype(np.float32) * 0.1,
                        f"v{i}": rs.rand(C).astype(np.float32) + 0.5})
    nodes = [
        _onnx_node("Conv", ["x", "w1"], ["c1"], kernel_shape=[3, 3],
                   pads=[1, 1, 1, 1]),
        _onnx_node("BatchNormalization", ["c1", "s1", "bb1", "m1", "v1"],
                   ["b1"], epsilon=1e-5),
        _onnx_node("Relu", ["b1"], ["r1"]),
        _onnx_node("Conv", ["r1", "w2"], ["c2"], kernel_shape=[3, 3],
                   pads=[1, 1, 1, 1]),
        _onnx_node("BatchNormalization", ["c2", "s2", "bb2", "m2", "v2"],
                   ["b2"], epsilon=1e-5),
        _onnx_node("Add", ["b2", "x"], ["sum"]),
        _onnx_node("Relu", ["sum"], ["r2"]),
        _onnx_node("GlobalAveragePool", ["r2"], ["gap"]),
        _onnx_node("Flatten", ["gap"], ["flat"]),
        _onnx_node("Gemm", ["flat", "fcw", "fcb"], ["y"], transB=1,
                   alpha=1.0, beta=1.0)]
    data = _onnx_model("resblock", nodes, tensors,
                       [("x", (B, C, side, side))], [("y", (B, classes))])
    return data, tensors


if __name__ == "__main__":
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(DATA, exist_ok=True)
    for key in BERT:
        pb = make_skeleton(key)
        with open(skeleton_path(key), "wb") as fh:
            fh.write(pb)
        print(key, len(pb), "bytes")
