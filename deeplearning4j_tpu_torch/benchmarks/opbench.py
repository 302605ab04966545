"""Per-op microbenchmark sweep with run-over-run regression accounting.

Counterpart of ``deeplearning4j_tpu/benchmarks/opbench.py`` (the role of
the reference's JMH suite, ``contrib/benchmarking_nd4j``, and of
``FullBenchmarkSuit.cpp``): time every registered op at a
representative shape and persist a JSON table, so that a later run can
be diffed and a per-op slowdown past ``--threshold`` fails the
comparison. A model-level benchmark cannot see one op regress inside a
whole step; this sweep times ops alone.

Usage::

    python -m deeplearning4j_tpu_torch.benchmarks.opbench --out ops.json
    python -m deeplearning4j_tpu_torch.benchmarks.opbench --compare ops.json

It runs on the card unless ``--device cpu`` is given, and stops with an
error when it finds no card. Arguments come from the JAX sweep's
candidate tables, drawn from the same ``RandomState(0)`` numpy draws and
moved to the device; the random ops get a seeded ``torch.Generator`` on
the device. Each benched op has two times, in microseconds a call:
- ``eager_us``: ``n_iter`` calls, then one synchronise;
- ``jit_us``: the port's counterpart of ``jax.jit``, one CUDA-graph
  capture of the call (after a warm-up on a side stream), replayed
  ``n_iter`` times, then one synchronise. An op that cannot be captured
  (a host sync: ``.item()``, ``eig``, ``num_segments=None``, a
  data-dependent shape), or whose capture records no kernel (a view, an
  identity, a creation op computed on the host: ``EmptyGraph``), keeps
  its ``eager_us``, gets ``jit_us: null`` and is named with its error
  under ``capture_failures``. On the CPU
  there is no capture, and every ``jit_us`` is null.
Ops that no candidate argument set satisfies are ``skipped`` and the
excluded ones ``excluded``, each with its reason: none is dropped
silently. The JSON and the summary carry the device's name and, on the
card, its name and power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

def _rng():
    return np.random.RandomState(0)


def _f32(*shape):
    return _rng().randn(*shape).astype(np.float32)


def _pos(*shape):
    return np.abs(_rng().randn(*shape)).astype(np.float32) + 0.1


def _unit(*shape):
    return _rng().uniform(0.05, 0.95, shape).astype(np.float32)


def _i32(*shape, hi=8):
    return _rng().randint(0, hi, shape).astype(np.int32)


def _bool(*shape):
    return _rng().rand(*shape) > 0.5


# Default benchmark shape: big enough that per-op device time dominates
# dispatch, small enough that a 555-op sweep stays minutes not hours.
N = 512


def _candidate_sets(category: str, key) -> List[Tuple[tuple, dict]]:
    """Ordered candidate (args, kwargs) per category; first that executes
    wins. Shapes chosen per family like FullBenchmarkSuit's suites.
    ``key`` is the random ops' seeded generator."""
    x = _f32(N, N)
    y = _f32(N, N)
    v = _f32(N)
    if category in ("transforms", "activations", "parity", "datatypes",
                    "util", "compression"):
        return [((_unit(N, N),), {}), ((x,), {}), ((x, y), {}),
                ((_pos(N, N),), {})]
    if category == "pairwise":
        return [((x, y), {}), ((_pos(N, N), _pos(N, N)), {})]
    if category in ("reduce", "indexreduce"):
        return [((x,), {"dims": [1]}), ((x,), {}), ((x, [1]), {})]
    if category == "reduce3":
        return [((x, y), {"dims": [1]}), ((x, y), {})]
    if category in ("blas", "linalg"):
        return [((x, y), {}), ((x,), {}),
                ((np.eye(N, dtype=np.float32) +
                  0.1 * _f32(N, N) @ _f32(N, N).T,), {})]
    if category == "shape":
        # small inputs: shape ops are probed blind, and some (tile, repeat,
        # meshgrid) produce outputs multiplicative in their operands — at
        # 512x512 a mis-probed candidate can hang the sweep
        s = _f32(64, 64)
        s2 = _f32(64, 64)
        return [((s,), {"shape": (64 * 64,)}), ((s,), {"axis": 0}),
                ((s,), {}), ((s, s2), {}), (([s, s2],), {}),
                ((s, (2, 2)), {}), ((s, 0), {})]
    if category == "gather":
        return [((x, _i32(64, hi=N)), {}), ((x, _i32(64, hi=N)),
                                            {"axis": 0})]
    if category == "scatter":
        idx = _i32(64, 1, hi=N)
        upd = _f32(64, N)
        return [((x, idx, upd), {}), ((_i32(64, hi=N), upd, [N, N]), {})]
    if category == "segment":
        seg = np.sort(_i32(N, hi=16))
        return [((v, seg), {"num_segments": 16}), ((_f32(N), seg, 16), {}),
                ((v, seg), {})]
    if category == "bitwise":
        a = _rng().randint(0, 1 << 16, (N, N)).astype(np.int32)
        b = _rng().randint(0, 16, (N, N)).astype(np.int32)
        return [((a, b), {}), ((a,), {})]
    if category == "activations":
        return [((x,), {})]
    if category == "loss":
        labels = np.eye(N, dtype=np.float32)[_i32(64, hi=N)]
        logits = _f32(64, N)
        return [((labels, _unit(64, N)), {}), ((labels, logits), {}),
                ((logits,), {"labels": labels}),
                ((labels, logits, None), {}),
                ((logits, None, labels), {}),
                ((logits,), {})]
    if category == "conv":
        img = _f32(8, 32, 64, 64)         # NCHW
        w = _f32(3, 3, 32, 64)            # HWIO (conv_ops convention)
        vol = _f32(4, 8, 16, 16, 16)      # NCDHW
        w3 = _f32(3, 3, 3, 8, 16)
        seq = _f32(8, 32, 64)             # NCW
        return [((img, w), {}),
                ((seq, _f32(3, 32, 64)), {}),
                ((vol, w3), {}),
                ((img, _f32(3, 3, 32, 2)), {}),   # depthwise multiplier
                ((img, _f32(3, 3, 32, 2), _f32(3, 3, 64, 128)), {}),
                ((img, _f32(3, 3, 64, 32)), {}),  # deconv HWOI
                ((img, 3, 3), {}),                # im2col
                ((_f32(4, 8, 3, 3, 30, 30),), {"h": 32, "w": 32}),
                ((img,), {}),
                ((img, (1, 3, 3, 1), (1, 1, 1, 1), (1, 1, 1, 1)), {})]
    if category == "pooling":
        img = _f32(8, 32, 64, 64)
        return [((img,), {"kernel": (2, 2)}), ((img, (2, 2)), {}),
                ((img,), {})]
    if category == "images":
        img = _unit(8, 64, 64, 3)
        return [((img,), {}), ((img, (32, 32)), {}),
                ((img,), {"size": (32, 32)})]
    if category == "recurrent":
        B, T, F, H = 16, 32, 64, 64
        seq = _f32(B, T, F)
        xt = _f32(B, F)
        return [
            # lstmLayer(x, w_x, w_h, b) / static_rnn / gru-style
            ((seq, _f32(F, 4 * H), _f32(H, 4 * H), _f32(4 * H)), {}),
            ((seq, _f32(F, H), _f32(H, H), _f32(H)), {}),
            # gru(x, h0, w_ru, w_c): gates packed [F+H, 2H] / [F+H, H]
            ((seq, _f32(B, H), _f32(F + H, 2 * H), _f32(F + H, H)), {}),
            # cells: (x_t, h_prev[, c_prev], weights...)
            ((xt, _f32(B, H), _f32(B, H), _f32(F, 4 * H), _f32(H, 4 * H)),
             {}),
            ((xt, _f32(B, H), _f32(F + H, 2 * H), _f32(F + H, H)), {}),
            # sru(x, c0, w[3F], b[2F])
            ((seq, _f32(B, F), _f32(F, 3 * F), _f32(2 * F)), {}),
            # lstmBlock(x[T,B,F] time-major, h0, c0, w[(F+H),4H], b[4H])
            ((_f32(T, B, F), _f32(B, H), _f32(B, H),
              _f32(F + H, 4 * H), _f32(4 * H)), {}),
            ((seq,), {}),
        ]
    if category == "random":
        return [((key, (N, N)), {}), ((key, x, 0.5), {}),
                ((key, x), {}), ((key, x, (64, 64)), {}),
                ((key, (N, N), 2.0), {}), ((key, x, 8), {}),
                (((N, N),), {}), ((), {}), ((1234,), {})]
    if category == "nn":
        return [((x,), {}), ((x, v, v), {}), ((x, y), {})]
    if category == "attention":
        q = _f32(4, 64, 8, 32)
        return [((q, q, q), {}), ((q,), {})]
    if category == "updater":
        return [((x, y), {"lr": 0.1}), ((x, y), {}), ((x, y, x), {})]
    if category == "nlp":
        vocab, dim, B = 1024, 64, 256
        return [((_f32(vocab, dim), _f32(vocab, dim), _i32(B, hi=vocab),
                  _i32(B, hi=vocab), _i32(B, 5, hi=vocab)), {})]
    # remaining categories are in EXCLUDED_CATEGORIES (graph machinery,
    # bp pairs, host-side string ops) and never reach here
    return []


def _op_overrides(key) -> Dict[str, List[Tuple[tuple, dict]]]:
    """Per-op argument candidates for ops whose category candidates can't
    satisfy their signatures (shape/index/seed/state-specific args). Tried
    before the category sets."""
    x = _f32(N, N)
    v = _f32(N)
    img = _unit(8, 64, 64, 3)                     # NHWC
    vol = _f32(4, 8, 16, 16, 16)                  # NCDHW
    B, T, F, H = 16, 32, 64, 64
    seq = _f32(B, T, F)
    pad22 = np.array([[2, 2], [2, 2]], np.int32)
    return {
        "Where": [((_bool(N, N), x, _f32(N, N)), {})],
        "alpha_dropout": [((x, 0.3, key), {})],
        "dropout": [((x, 0.3, key), {})],
        "gaussian_dropout": [((x, 0.3, key), {})],
        "gaussian_noise": [((x, 0.1, key), {})],
        "ams_grad_updater": [((x, _pos(N, N), _f32(N, N), _pos(N, N)), {})],
        "avgpool3dnew": [((vol,), {"kernel": (2, 2, 2)}), ((vol,), {})],
        "batch_to_space": [((_f32(16, 16, 16, 8), [2, 2],
                             [[0, 0], [0, 0]]), {})],
        "extract_image_patches": [((img, (3, 3), (1, 1), (1, 1)), {})],
        "space_to_batch": [((_f32(4, 32, 32, 8), [2, 2],
                             [[0, 0], [0, 0]]), {})],
        "betainc": [((_unit(N, N) * 4 + 0.5, _unit(N, N) * 4 + 0.5,
                      _unit(N, N)), {})],
        "bincount": [((_i32(N * N, hi=64),), {"minlength": 64})],
        "boolean_not": [((_bool(N, N),), {})],
        "broadcast_to": [((v, (N, N)), {})],
        "cbow": [((_f32(1024, 64), _f32(1024, 64),
                   _i32(256, 8, hi=1024),
                   np.ones((256, 8), np.float32),
                   _i32(256, hi=1024), _i32(256, 5, hi=1024)), {})],
        "clipbyvalue": [((x, -0.5, 0.5), {})],
        "confusion_matrix": [((_i32(N, hi=16), _i32(N, hi=16)),
                              {"num_classes": 16})],
        "create": [(((N, N),), {})],
        "crop_and_resize": [((img, _unit(16, 4), _i32(16, hi=8),
                              (16, 16)), {})],
        "cross": [((_f32(N, 3), _f32(N, 3)), {})],
        "cross_batched": [((_f32(N, 3), _f32(N, 3)), {})],
        "ctc_loss": [((_i32(8, 20, hi=30) + 1, _f32(8, 64, 32),
                       np.full(8, 20, np.int32),
                       np.full(8, 64, np.int32)), {})],
        "deconv2d_tf": [((np.array([8, 64, 64, 32], np.int32),
                          _f32(3, 3, 32, 64), _f32(8, 32, 32, 64)),
                         {"strides": (2, 2)})],
        "deconv3d": [((vol, _f32(3, 3, 3, 8, 8)), {}),
                     ((vol, _f32(3, 3, 3, 8, 16)), {})],
        "depth_to_space": [((_f32(8, 32, 32, 64), 2), {})],
        "dilation2d": [((img, _f32(3, 3, 3)), {})],
        "draw_bounding_boxes": [((img, _unit(8, 4, 4)), {})],
        "dynamic_stitch": [(([_i32(64, hi=128), _i32(64, hi=128)],
                             [_f32(64), _f32(64)]), {})],
        "einsum": [((x, _f32(N, N)), {"equation": "ij,jk->ik"})],
        "eye": [((N,), {})],
        "fake_quant_with_min_max_vars": [((x, -1.0, 1.0), {})],
        "fake_quant_with_min_max_vars_per_channel": [
            ((x, -_pos(N), _pos(N)), {})],
        "fill": [(((N, N), 3.0), {})],
        "gather_nd": [((x, _i32(64, 2, hi=N)), {})],
        "gru_onnx": [((_f32(T, B, F), _f32(3 * H, F), _f32(3 * H, H),
                       _f32(6 * H)), {})],
        "histogram": [((v, 32), {})],
        "histogram_fixed_width": [((v, (-2.0, 2.0), 32), {})],
        "im2col": [((_f32(8, 32, 64, 64), 3, 3), {})],
        "image_resize": [((img, (32, 32)), {})],
        "in_top_k": [((_f32(64, N), _i32(64, hi=N), 5), {})],
        "invert_permutation": [((np.random.RandomState(0)
                                 .permutation(N).astype(np.int32),), {})],
        "knn_mindistance": [((v, v - 1.0, v + 1.0), {})],
        "lin_space": [((0.0, 1.0, N), {})],
        "lstmBlockCell": [((_f32(B, F), _f32(B, H), _f32(B, H),
                            _f32(F + H, 4 * H), _f32(4 * H)), {})],
        "lstmLayer_bidirectional": [((seq, _f32(F, 4 * H), _f32(H, 4 * H),
                                      _f32(4 * H), _f32(F, 4 * H),
                                      _f32(H, 4 * H), _f32(4 * H)), {})],
        "matrix_band_part": [((x, 2, 2), {})],
        "matrix_set_diag": [((x, v), {})],
        "meshgrid": [((v, _f32(64)), {})],
        "mirror_pad": [((x, [[2, 2], [2, 2]]), {})],
        "multi_head_dot_product_attention": [
            ((_f32(4, 64, 64), _f32(4, 64, 64), _f32(4, 64, 64),
              _f32(64, 8, 32), _f32(64, 8, 32), _f32(64, 8, 32),
              _f32(8 * 32, 64)), {})],
        "non_max_suppression": [((_unit(64, 4), _unit(64), 16), {})],
        "non_max_suppression_overlaps": [((_unit(64, 64), _unit(64), 16),
                                          {})],
        "normalize_moments": [((np.float32(N), v * N, _pos(N) * N), {})],
        "onehot": [((_i32(N, hi=N), N), {})],
        "pad": [((x, [[2, 2], [2, 2]]), {})],
        "percentile": [((x, 50.0), {})],
        "permute": [((x, (1, 0)), {})],
        "polygamma": [((np.ones((N, N), np.int32), _pos(N, N)), {})],
        "random_bernoulli": [((key, (N, N)), {})],
        "random_crop": [((key, x, (64, 64)), {})],
        "random_exponential": [((key, (N, N)), {})],
        "random_gamma": [((key, (N, N), 2.0), {})],
        "random_multinomial": [((key, _f32(64, 32), 16), {})],
        "random_normal": [((key, (N, N)), {})],
        "random_poisson": [((key, (N, N), 3.0), {})],
        "randomuniform": [((key, (N, N)), {})],
        "range": [((0, N, 1), {})],
        "reduce_dot": [((x, _f32(N, N)), {"dims": [1]})],
        "repeat": [((x, 2), {"axis": 0})],
        "resize_area": [((img,), {"size": (32, 32)})],
        "resize_bicubic": [((img,), {"size": (32, 32)})],
        "resize_bilinear": [((img,), {"size": (32, 32)})],
        "resize_nearest_neighbor": [((img,), {"size": (32, 32)})],
        "reverse_sequence": [((seq, _i32(B, hi=T) + 1), {})],
        "scatter_add": [((x, _i32(64, hi=N), _f32(64, N)), {})],
        "scatter_div": [((x, _i32(64, hi=N), _pos(64, N)), {})],
        "scatter_max": [((x, _i32(64, hi=N), _f32(64, N)), {})],
        "scatter_min": [((x, _i32(64, hi=N), _f32(64, N)), {})],
        "scatter_mul": [((x, _i32(64, hi=N), _f32(64, N)), {})],
        "scatter_sub": [((x, _i32(64, hi=N), _f32(64, N)), {})],
        "scatter_upd": [((x, _i32(64, hi=N), _f32(64, N)), {})],
        "scatter_nd": [((_i32(64, 1, hi=N), _f32(64, N), [N, N]), {})],
        "select": [((_bool(N, N), x, _f32(N, N)), {})],
        "sequence_mask": [((_i32(N, hi=64) + 1,), {"maxlen": 64})],
        "size_at": [((x, 0), {})],
        "slice": [((x, (0, 0), (64, 64)), {})],
        "space_to_depth": [((_f32(8, 64, 64, 16), 2), {})],
        "sparse_softmax_cross_entropy_loss_with_logits": [
            ((_i32(64, hi=N), _f32(64, N)), {})],
        "split": [((x, 4), {"axis": 0})],
        "split_v": [((x, [128, 128, 256]), {"axis": 0})],
        "sru_bi": [((seq, _f32(F, 3 * F), _f32(2 * F), _f32(F, 3 * F),
                     _f32(2 * F)), {})],
        "sruCell": [((_f32(B, F), _f32(B, F), _f32(F, 3 * F),
                      _f32(2 * F)), {})],
        "static_bidirectional_rnn": [((seq, _f32(F, H), _f32(H, H),
                                       _f32(H), _f32(F, H), _f32(H, H),
                                       _f32(H)), {})],
        "strided_slice": [((x, (0, 0), (N, N), (2, 2)), {})],
        "tensormmul": [((x, _f32(N, N), [1], [0]), {})],
        "tf_strided_slice": [((x, ((0, N, 2), (0, N, 2))), {}),
                             ((x, [(0, N, 2), (0, N, 2)]), {})],
        "tile": [((_f32(64, 64), (2, 2)), {})],
        "tile_to_shape": [((_f32(64, 64), (8, 64, 64)), {})],
        "top_k": [((x, 8), {})],
        "tri": [((N,), {})],
        "upsampling2d": [((_f32(8, 32, 32, 32),), {})],
        "upsampling3d": [((vol,), {})],
        "weighted_cross_entropy_with_logits": [((_unit(64, N),
                                                 _f32(64, N), 2.0), {})],
    }


#: categories excluded by design (not standalone numeric array ops —
#: graph machinery, bp pairs, or host-side string ops); reported, not
#: silently dropped
EXCLUDED_CATEGORIES = ("controlflow", "list", "autodiff_bp", "tsne",
                       "decoder", "strings")

#: individually excluded ops, with reasons: shape-inference helpers that
#: run on host values, and ops whose output shape is data-dependent (the
#: JAX sweep's exclusions, kept so that the two sweeps bench the same
#: names)
EXCLUDED_OPS = {
    "broadcast_dynamic_shape": "host-side shape inference (returns a shape)",
    "broadcastgradientargs": "host-side shape inference (returns axes)",
    "evaluate_reduction_shape": "host-side shape inference (returns a shape)",
    "hashcode": "host-side scalar hash of concrete values",
    "choose": "data-dependent output shape (boolean filter)",
    "dynamic_partition": "data-dependent partition sizes",
    "listdiff": "data-dependent output shape (set difference)",
    "set_seed": "host-side RNG state mutation, no array output",
}


def _to_device(a, device):
    """numpy arrays (and numpy scalars) as tensors on ``device``, inside
    lists and tuples too; strings, shapes and Python values as they
    are."""
    import torch
    if isinstance(a, np.ndarray) and a.dtype.kind not in ("U", "S", "O"):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if isinstance(a, np.generic) and not isinstance(a, (np.str_,
                                                        np.bytes_)):
        return torch.tensor(a.item(), dtype=torch.from_numpy(
            np.asarray(a)).dtype, device=device)
    if isinstance(a, list):
        return [_to_device(v, device) for v in a]
    if isinstance(a, tuple):
        return tuple(_to_device(v, device) for v in a)
    return a


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in _leaves(o)]
    if isinstance(out, dict):
        return [leaf for k in sorted(out) for leaf in _leaves(out[k])]
    return [out]


def _size(out) -> int:
    import torch
    return sum(o.numel() if isinstance(o, torch.Tensor) else int(np.size(o))
               for o in _leaves(out) if hasattr(o, "shape"))


def _shape(a) -> List[int]:
    """``np.shape`` of an argument, tensors and lists of them included."""
    if hasattr(a, "shape"):
        return [int(s) for s in a.shape]
    if isinstance(a, (list, tuple)) and a and hasattr(a[0], "shape"):
        return [len(a)] + _shape(a[0])
    try:
        return list(np.shape(a))
    except ValueError:   # a ragged list
        return []


def _generators(args) -> list:
    import torch
    return [a for a in _leaves(list(args)) if isinstance(a, torch.Generator)]


def _time_fn(fn, n_iter: int, sync) -> float:
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn()
    sync()
    return (time.perf_counter() - t0) / n_iter * 1e6  # us


def _graph_us(fn, n_iter: int, generators) -> float:
    """One CUDA-graph capture of ``fn`` replayed ``n_iter`` times, in us a
    replay. A failed capture raises and leaves the stream usable; so does
    one that recorded no kernel (``EmptyGraph``: the op launches nothing
    on the card, a view or work on the host, and a replay would time
    nothing)."""
    import torch
    from ..runtime.cuda_graphs import EmptyGraph, empty_capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with empty_capture() as seen:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            fn()
    if seen.empty:
        raise EmptyGraph("the capture recorded no kernel: the op launches "
                         "nothing on the card")
    graph.replay()
    torch.cuda.synchronize()
    return _time_fn(graph.replay, n_iter, torch.cuda.synchronize)


def device_provenance(device: str) -> Dict:
    """The platform, the device's name and, on the card, ``nvidia-smi``'s
    name and power limit."""
    import torch
    if device == "cpu":
        return {"platform": "cpu", "device_name": "cpu",
                "nvidia_smi": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        smi = [f"nvidia-smi failed: {e}"]
    index = torch.device(device).index or 0
    return {"platform": "cuda",
            "device_name": torch.cuda.get_device_name(index),
            "nvidia_smi": smi[index] if index < len(smi) else
            (smi[0] if smi else None)}


def run_opbench(filter_category: Optional[str] = None,
                filter_name: Optional[str] = None,
                n_iter: int = 20, device: str = "cuda") -> Dict:
    """Benchmark every registered op it can synthesize inputs for, on
    ``device`` (the card by default; there is no fallback to the CPU).

    Returns {"results": {op: {category, eager_us, jit_us, args}},
    "skipped", "skip_reasons", "excluded", "capture_failures",
    "platform", "device_name", "nvidia_smi", "n_benched"}.
    """
    import torch

    from ..ops.registry import OpRegistry

    on_card = device != "cpu"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError(f"opbench: no CUDA device for {device!r} (run "
                           "with --device cpu to sweep the CPU)")
    dev = torch.device(device)
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def fresh_key():
        return torch.Generator(device=dev).manual_seed(0)

    reg = OpRegistry.get()
    results: Dict[str, Dict] = {}
    skipped: List[str] = []
    skip_reasons: Dict[str, str] = {}
    excluded: List[str] = []
    capture_failures: Dict[str, str] = {}
    overrides = _op_overrides(fresh_key())

    for name in reg.names():
        d = reg.lookup(name)
        if filter_category and d.category != filter_category:
            continue
        if filter_name and filter_name not in name:
            continue
        if d.category in EXCLUDED_CATEGORIES or name.endswith("_bp") \
                or name in EXCLUDED_OPS:
            excluded.append(name)
            continue
        bench = None
        last_err = "no candidate argument set for category"
        for args, kwargs in (overrides.get(name, [])
                             + _candidate_sets(d.category, fresh_key())):
            try:
                targs = _to_device(list(args), dev)
                out = d.fn(*targs, **kwargs)
                sync()
                if _size(out) > 64 * N * N:
                    last_err = "candidate output explosively large"
                    continue  # mis-probed candidate with explosive output
                bench = (targs, kwargs)
                break
            except Exception as e:   # noqa: BLE001 (the next candidate)
                last_err = f"{type(e).__name__}: {str(e)[:120]}"
                continue
        if bench is None:
            skipped.append(name)
            skip_reasons[name] = last_err
            continue
        targs, kwargs = bench
        call = lambda: d.fn(*targs, **kwargs)  # noqa: E731
        try:
            eager_us = _time_fn(call, n_iter, sync)
        except Exception as e:   # noqa: BLE001 (reported as skipped)
            skipped.append(name)
            skip_reasons[name] = (f"timing failed: {type(e).__name__}: "
                                  f"{str(e)[:120]}")
            continue
        jit_us = None
        if on_card:
            try:
                jit_us = round(_graph_us(call, n_iter, _generators(targs)),
                               2)
            except Exception as e:   # noqa: BLE001 (reported by name)
                first = (str(e).splitlines() or [""])[0]
                capture_failures[name] = f"{type(e).__name__}: {first[:160]}"
                torch.cuda.synchronize()
        results[name] = {
            "category": d.category,
            "eager_us": round(eager_us, 2),
            "jit_us": jit_us,
            "args": [_shape(a) for a in targs],
        }
    return {"results": results, "skipped": sorted(skipped),
            "skip_reasons": {k: skip_reasons[k] for k in sorted(skip_reasons)},
            "excluded": sorted(excluded),
            "capture_failures": {k: capture_failures[k]
                                 for k in sorted(capture_failures)},
            **device_provenance(device),
            "n_benched": len(results)}


def op_us(r: Dict) -> float:
    """An op's time: its captured replay where it has one, else eager."""
    return r["jit_us"] if r.get("jit_us") is not None else r["eager_us"]


def compare_runs(baseline: Dict, current: Dict,
                 threshold: float = 2.0,
                 min_us: float = 50.0) -> List[Dict]:
    """Regressions: ops whose time grew > threshold x against the
    baseline, compared on ``jit_us`` where both runs have it and on
    ``eager_us`` otherwise.

    ``min_us`` floors out dispatch jitter: an op has to be slower than
    ``min_us`` in the current run before it can count as a regression.
    """
    regressions = []
    base = baseline.get("results", {})
    cur = current.get("results", {})
    for name, c in cur.items():
        b = base.get(name)
        if b is None:
            continue
        key = "jit_us" if c.get("jit_us") is not None and \
            b.get("jit_us") is not None else "eager_us"
        if c[key] > min_us and c[key] > threshold * b[key]:
            regressions.append({"op": name, "timing": key,
                                "baseline_us": b[key], "current_us": c[key],
                                "ratio": round(c[key] / b[key], 2)})
    return sorted(regressions, key=lambda r: -r["ratio"])


def summary(out: Dict, top: int = 10) -> List[str]:
    """The printed summary: counts, every op not benched with its reason,
    and the ``top`` slowest ops."""
    lines = [f"benched {out['n_benched']} ops "
             f"({len(out['skipped'])} skipped, "
             f"{len(out['excluded'])} excluded by design, "
             f"{len(out['capture_failures'])} not captured) "
             f"on {out['platform']}: {out['device_name']}"
             + (f" [{out['nvidia_smi']}]" if out.get("nvidia_smi") else "")]
    for op in out["skipped"]:
        lines.append(f"  SKIP {op}: {out['skip_reasons'].get(op, '?')}")
    for op, err in out["capture_failures"].items():
        lines.append(f"  NO CAPTURE {op}: {err}")
    worst = sorted(out["results"].items(), key=lambda kv: -op_us(kv[1]))
    for name, r in worst[:top]:
        jit = "null" if r["jit_us"] is None else f"{r['jit_us']:.1f}us"
        lines.append(f"  {name:32s} {jit:>12s} graph "
                     f"{r['eager_us']:10.1f}us eager  [{r['category']}]")
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", help="write results JSON here")
    p.add_argument("--compare", help="baseline JSON; exit 1 on "
                                     "--threshold regressions")
    p.add_argument("--category", help="bench only this category")
    p.add_argument("--op", help="bench only ops containing this substring")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--threshold", type=float, default=2.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)

    try:
        out = run_opbench(filter_category=args.category,
                          filter_name=args.op, n_iter=args.iters,
                          device=args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for line in summary(out):
        print(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    if args.compare:
        with open(args.compare) as f:
            baseline = json.load(f)
        regs = compare_runs(baseline, out, threshold=args.threshold)
        if regs:
            print(f"REGRESSIONS ({len(regs)}):")
            for r in regs:
                print(f"  {r['op']}: {r['baseline_us']}us -> "
                      f"{r['current_us']}us ({r['ratio']}x, "
                      f"{r['timing']})")
            return 1
        print("no per-op regressions")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
