"""The parity-op tail: the reference ops no family module holds.

Counterpart of ``deeplearning4j_tpu/ops/parity_extra.py``: the
``headers/parity_ops.h`` stragglers (Assert, confusion_matrix,
fake_quant*, compare_and_bitpack, create_view, norm, min_max_datatype,
broadcastgradientargs), ``headers/convo.h``'s deconv2d_tf and
conv2d_input_bp, ``headers/decoder.h``'s ctc_beam,
``headers/util.h``'s print_variable and ``headers/BarnesHutTsne.h``'s
t-SNE kernels. The port is eager, so ``Assert`` raises at once; the
beam search, ``barnes_symmetrized`` and ``broadcastgradientargs`` are
host code, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ._util import narrow, tensor_like
from .conv_ops import conv2d, deconv2d
from .registry import op


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _on_device(v, like):
    """``v`` in ``like``'s dtype on its device; a Python number is filled
    there (no host-to-device copy, which a CUDA-graph capture refuses)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=like.dtype)
    if isinstance(v, (int, float)):
        return torch.full((), v, dtype=like.dtype, device=like.device)
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _device(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


@op("Assert", "parity", differentiable=False)
def assert_op(condition, *data, message="assertion failed"):
    """Raises ``AssertionError(message)`` unless every element of
    ``condition`` holds (a host sync on the card)."""
    cond = torch.as_tensor(condition)
    if not bool(torch.all(cond)):
        raise AssertionError(message)
    return torch.tensor(True, device=cond.device)


@op("confusion_matrix", "parity", differentiable=False)
def confusion_matrix(labels, predictions, num_classes=None, weights=None):
    """Counts (or summed ``weights``) of each (label, prediction) pair,
    with the JAX op's ``.at[label * n + prediction].add`` indexing: a
    flat index below 0 counts from the end, one past ``n * n`` is
    dropped (masked here, since ``index_add_`` would assert on the
    card)."""
    labels = torch.as_tensor(labels)
    predictions = tensor_like(predictions, labels)
    n = int(num_classes) if num_classes is not None else \
        int(torch.maximum(labels.max(), predictions.max())) + 1
    idx = (labels.to(torch.int32) * n + predictions.to(torch.int32)).long()
    idx = idx.reshape(-1)
    idx = torch.where(idx < 0, idx + n * n, idx)
    w = torch.ones(idx.shape, dtype=torch.float32, device=idx.device) \
        if weights is None else tensor_like(weights, labels).reshape(-1)
    keep = (idx >= 0) & (idx < n * n)
    cm = torch.zeros(n * n + 1, dtype=w.dtype, device=idx.device)
    cm.index_add_(0, torch.where(keep, idx, torch.full_like(idx, n * n)), w)
    return cm[:n * n].reshape(n, n)


@op("fake_quant_with_min_max_vars", "parity")
def fake_quant_with_min_max_vars(x, min_val, max_val, num_bits=8,
                                 narrow_range=False):
    qmin = 1.0 if narrow_range else 0.0
    qmax = float(2 ** int(num_bits) - 1)
    mn, mx = _on_device(min_val, x), _on_device(max_val, x)
    scale = (mx - mn) / (qmax - qmin)
    # the zero point through an inverse-scale multiply, and std::round's
    # half-away-from-zero as floor(z + 0.5) (z >= qmin >= 0 after the
    # clip), as the JAX op computes them
    inv_scale = (qmax - qmin) / (mx - mn)
    zero = torch.clamp(torch.floor(qmin - mn * inv_scale + 0.5), qmin, qmax)
    nudged_min = (qmin - zero) * scale
    nudged_max = (qmax - zero) * scale
    clipped = torch.clamp(x, nudged_min, nudged_max)
    q = torch.round((clipped - nudged_min) * inv_scale)
    return q * scale + nudged_min


@op("fake_quant_with_min_max_vars_per_channel", "parity")
def fake_quant_per_channel(x, min_val, max_val, num_bits=8,
                           narrow_range=False):
    return fake_quant_with_min_max_vars(x, min_val, max_val, num_bits,
                                        narrow_range)


@op("compare_and_bitpack", "parity", differentiable=False)
def compare_and_bitpack(x, threshold):
    """``x > threshold`` packed into uint8, 8 values a byte, first value
    in the high bit (the TF op)."""
    bits = (x > tensor_like(threshold, x)).to(torch.uint8)
    flat = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // 8, 8))
    weights = (1 << torch.arange(7, -1, -1, device=x.device)).to(torch.uint8)
    return torch.sum(flat * weights, dim=-1).to(torch.uint8)


@op("create_view", "parity", differentiable=False)
def create_view(x, *index_args, **_):
    """The reference's strided view: ``x`` itself (views are the NDArray
    layer's)."""
    return torch.as_tensor(x)


@op("norm", "parity")
def norm(x, mode=0, dims=None, keep_dims=False):
    """Mode 0 (``"fro"``, ``"euclidean"``): 2-norm; 1 (``"max"``,
    ``"inf"``): max norm; else the 1-norm; over ``dims`` or all."""
    axis = tuple(dims) if dims else None
    if mode in (0, "fro", "euclidean"):
        return torch.sqrt(torch.sum(torch.square(x), dim=axis,
                                    keepdim=keep_dims))
    if mode in (1, "max", "inf"):
        a = torch.abs(x)
        return torch.amax(a, dim=axis if axis else tuple(range(a.dim())),
                          keepdim=keep_dims)
    return torch.sum(torch.abs(x), dim=axis, keepdim=keep_dims)


@op("min_max_datatype", "datatypes", differentiable=False)
def min_max_datatype(dtype, min_or_max=0):
    """The least (``min_or_max=0``) or greatest value of ``dtype``, in
    that dtype (64-bit types narrowed to 32 bits, as the JAX package
    runs; a 64-bit integer's bounds do not fit and raise); on a tensor
    ``dtype``'s device, else the default one."""
    from ..common.dtype import DataType
    device = dtype.device if isinstance(dtype, torch.Tensor) else None
    wide = DataType.from_any(dtype).torch
    info = torch.finfo(wide) if wide.is_floating_point else torch.iinfo(wide)
    value = info.min if min_or_max == 0 else info.max
    dt = narrow(wide)
    if dt.is_floating_point:
        if abs(value) > torch.finfo(dt).max:    # float64's: +-inf in f32
            value = float("inf") if value > 0 else float("-inf")
    elif not torch.iinfo(dt).min <= value <= torch.iinfo(dt).max:
        raise OverflowError(f"Python integer {value} out of bounds for "
                            f"{str(dt).replace('torch.', '')}")
    return torch.full((), value, dtype=dt, device=device)


@op("broadcastgradientargs", "parity", differentiable=False)
def broadcast_gradient_args(shape_a, shape_b):
    """The axes each operand was broadcast over (TF's
    BroadcastGradientArgs), as host int64 arrays."""
    sa = [int(s) for s in _numpy(shape_a).reshape(-1)]
    sb = [int(s) for s in _numpy(shape_b).reshape(-1)]
    rank = max(len(sa), len(sb))
    pa = [1] * (rank - len(sa)) + sa
    pb = [1] * (rank - len(sb)) + sb
    ra = [i for i in range(rank) if pa[i] == 1 and pb[i] != 1]
    rb = [i for i in range(rank) if pb[i] == 1 and pa[i] != 1]
    return (np.asarray(ra, np.int64), np.asarray(rb, np.int64))


@op("deconv2d_tf", "conv")
def deconv2d_tf(output_shape, weights, grad_out, strides=(1, 1),
                padding="SAME", data_format="NHWC"):
    """TF's Conv2DBackpropInput: a transposed convolution of
    ``grad_out``; ``output_shape`` is not read, as in the JAX op."""
    return deconv2d(grad_out, weights, None, strides=strides,
                    padding=padding, data_format=data_format)


@op("conv2d_input_bp", "conv")
def conv2d_input_bp(input_shape, weights, grad_out, strides=(1, 1),
                    padding="SAME", dilation=(1, 1), data_format="NCHW"):
    """The gradient of ``conv2d`` with respect to an input of
    ``input_shape``: its vector-Jacobian product with ``grad_out``
    (kept differentiable when the weights or ``grad_out`` are)."""
    shape = tuple(int(s) for s in _numpy(input_shape).reshape(-1))
    outer = torch.is_grad_enabled() and (weights.requires_grad
                                         or grad_out.requires_grad)
    with torch.enable_grad():
        x = torch.zeros(shape, dtype=weights.dtype, device=weights.device,
                        requires_grad=True)
        out = conv2d(x, weights, None, strides=strides, padding=padding,
                     dilation=dilation, data_format=data_format)
        (gx,) = torch.autograd.grad(out, x, grad_out, create_graph=outer)
    return gx


@op("ctc_beam", "decoder", differentiable=False)
def ctc_beam(logits, sequence_length=None, beam_width=8, blank_index=0,
             top_paths=1):
    """CTC beam search on the host (the reference's
    ``headers/decoder.h``). ``logits`` [B, T, C] or [T, C]; returns
    ``(paths [B, top, T] int32, -1 past each path's end, log_probs
    [B, top])`` on the logits' device."""
    arr = _numpy(logits).astype(np.float32)
    if arr.ndim == 2:
        arr = arr[None]
    lengths = None if sequence_length is None else \
        _numpy(sequence_length).reshape(-1)
    B, T, C = arr.shape
    logp = arr - np.logaddexp.reduce(arr, axis=-1, keepdims=True)
    out_paths = np.full((B, top_paths, T), -1, np.int32)
    out_logp = np.full((B, top_paths), -np.inf, np.float32)
    for b in range(B):
        Tb = int(lengths[b]) if lengths is not None else T
        # beam: prefix tuple -> (p_blank, p_nonblank) in log space
        beams = {(): (0.0, -np.inf)}
        for t in range(Tb):
            new = {}
            for prefix, (pb, pnb) in beams.items():
                for c in range(C):
                    p = logp[b, t, c]
                    if c == blank_index:
                        npb, nnb = new.get(prefix, (-np.inf, -np.inf))
                        new[prefix] = (np.logaddexp(
                            npb, np.logaddexp(pb, pnb) + p), nnb)
                        continue
                    key = prefix + (c,)
                    npb, nnb = new.get(key, (-np.inf, -np.inf))
                    if prefix and prefix[-1] == c:
                        nnb = np.logaddexp(nnb, pb + p)
                        opb, onb = new.get(prefix, (-np.inf, -np.inf))
                        new[prefix] = (opb, np.logaddexp(onb, pnb + p))
                    else:
                        nnb = np.logaddexp(nnb, np.logaddexp(pb, pnb) + p)
                    new[key] = (npb, nnb)
            ranked = sorted(new.items(),
                            key=lambda kv: -np.logaddexp(*kv[1]))
            beams = dict(ranked[:beam_width])
        ranked = sorted(beams.items(), key=lambda kv: -np.logaddexp(*kv[1]))
        for k, (prefix, probs) in enumerate(ranked[:top_paths]):
            out_paths[b, k, :len(prefix)] = prefix
            out_logp[b, k] = np.logaddexp(*probs)
    dev = _device(logits)
    return (torch.from_numpy(out_paths).to(dev),
            torch.from_numpy(out_logp).to(dev))


@op("print_variable", "util", differentiable=False)
def print_variable(x, message=""):
    """Prints ``message`` and the values of ``x``, then returns ``x``."""
    print(message + str(_numpy(x)))
    return x


# -- Barnes-Hut t-SNE kernels (reference BarnesHutTsne.h) -----------------

@op("barnes_symmetrized", "tsne", differentiable=False)
def barnes_symmetrized(row_p, col_p, val_p, n=None):
    """A sparse CSR affinity matrix symmetrised, ``(P + Pᵀ) / 2``, dense
    ``[n, n]``; built on the host, returned on ``val_p``'s device."""
    rows = _numpy(row_p).astype(np.int64)
    cols = _numpy(col_p).astype(np.int64)
    vals = _numpy(val_p)
    n = int(n) if n is not None else len(rows) - 1
    dense = np.zeros((n, n), vals.dtype)
    for i in range(n):
        for k in range(rows[i], rows[i + 1]):
            dense[i, cols[k]] = vals[k]
    sym = torch.from_numpy((dense + dense.T) / 2.0)
    return sym.to(device=_device(val_p), dtype=narrow(sym.dtype))


@op("barnes_edge_forces", "tsne")
def barnes_edge_forces(p_matrix, y):
    """t-SNE's attractive forces: sum_j p_ij (y_i - y_j) / (1 + |d|²)."""
    diff = y[:, None, :] - y[None, :, :]            # [n, n, d]
    dist = 1.0 + torch.sum(diff * diff, dim=-1)
    return torch.einsum("ij,ijd->id", p_matrix / dist, diff)


@op("barnes_gains", "tsne", differentiable=False)
def barnes_gains(gains, grad, prev_grad, min_gain=0.01):
    """t-SNE's adaptive gain update."""
    new = torch.where((grad * prev_grad) > 0, gains * 0.8, gains + 0.2)
    return torch.clamp(new, min=min_gain)


@op("cell_contains", "tsne", differentiable=False)
def cell_contains(corner, width, point):
    """The Barnes-Hut quadtree's membership test."""
    lo = corner - width / 2.0
    hi = corner + width / 2.0
    return torch.all((point >= lo) & (point <= hi), dim=-1)
