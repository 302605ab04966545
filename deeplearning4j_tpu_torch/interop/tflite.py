"""TFLite model runner: execute ``.tflite`` files on ``device``.

Counterpart of ``deeplearning4j_tpu/interop/tflite.py`` (the reference's
foreign-runtime interop family: nd4j-tensorflow GraphRunner /
nd4j-onnxruntime / nd4j-tvm). The ``.tflite`` wire format is FlatBuffers
(schema: tensorflow/lite/schema/schema.fbs); this reader walks it with the
port's own ``modelimport/flatbuf.py`` and maps each float builtin op that
the JAX runner maps onto torch ops. Where the JAX runner compiles the whole
subgraph into one XLA computation, the port runs it through
``runtime.inference.captured_dispatch``: one CUDA graph per input
signature on the card, replayed by every later call (the same body run
eagerly on the CPU).

Scope, errors and semantics are the JAX runner's: float32 inference graphs
(the conversion default); quantized models, dynamic-range weight-only int8
included, are refused. Supported builtins: CONV_2D, DEPTHWISE_CONV_2D,
FULLY_CONNECTED, the pooling pair, elementwise ADD/SUB/MUL/DIV with fused
activations, RELU/RELU6/TANH/LOGISTIC, SOFTMAX, RESHAPE, CONCATENATION,
MEAN, TRANSPOSE, PAD, SQUEEZE, MAX/MIN, SQUARED_DIFFERENCE, SHAPE/PACK
shape chains and STRIDED_SLICE.

Constant buffers become tensors on ``device`` once, when the runner is
built (the graph's params). Shape arguments (a RESHAPE's shape, a PAD's
pads, STRIDED_SLICE's bounds, MEAN's axes, TRANSPOSE's permutation) are
read from the host copy of their constant, and SHAPE answers on the host
from the static shape, so the captured body never syncs the host.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..bridge import tensor_from_numpy
from ..modelimport import flatbuf as fb
from ..ndarray.ndarray import NDArray
from ..ops import conv_ops

# -- schema enums (tensorflow/lite/schema/schema.fbs) ----------------------

_TENSOR_TYPES = {0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8,
                 4: np.int64, 6: np.bool_, 7: np.int16, 9: np.int8}

# BuiltinOperator codes used below
_OP_NAMES = {
    0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION", 3: "CONV_2D",
    4: "DEPTHWISE_CONV_2D", 9: "FULLY_CONNECTED", 14: "LOGISTIC",
    17: "MAX_POOL_2D", 18: "MUL", 19: "RELU", 21: "RELU6", 22: "RESHAPE",
    25: "SOFTMAX", 28: "TANH", 34: "PAD", 39: "TRANSPOSE", 40: "MEAN",
    41: "SUB", 42: "DIV", 43: "SQUEEZE", 45: "STRIDED_SLICE",
    55: "MAXIMUM", 57: "MINIMUM", 77: "SHAPE", 83: "PACK",
    99: "SQUARED_DIFFERENCE",
}

_FUSED_ACT = {0: None, 1: "relu", 2: "relu_n1_to_1", 3: "relu6", 4: "tanh",
              5: "sign"}

_BINARY = {"ADD": torch.add, "SUB": torch.sub, "MUL": torch.mul,
           "DIV": torch.div, "MAXIMUM": torch.maximum,
           "MINIMUM": torch.minimum,
           "SQUARED_DIFFERENCE": lambda x, y: (x - y) ** 2}


def _apply_fused(x, code):
    act = _FUSED_ACT.get(code)
    if act is None:
        return x
    if act == "relu":
        return torch.relu(x)
    if act == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if act == "relu_n1_to_1":
        return torch.clamp(x, -1.0, 1.0)
    if act == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unsupported fused activation code {code}")


def _padding(code: int) -> str:
    return "SAME" if code == 0 else "VALID"


class _Tensor:
    __slots__ = ("shape", "dtype", "type_code", "buffer_idx", "name",
                 "quantized")

    def __init__(self, t):
        self.shape = fb.vec_i32(t, 0)
        self.type_code = fb.i8(t, 1, 0)
        self.dtype = _TENSOR_TYPES.get(self.type_code)
        self.buffer_idx = fb.u32(t, 2)
        self.name = fb.string(t, 3)
        q = fb.subtable(t, 4)
        # QuantizationParameters: scale vector at slot 2 non-empty => real
        # quantization (float models carry an empty table)
        self.quantized = q is not None and fb.vec_len(q, 2) > 0


class _Op:
    __slots__ = ("opcode_index", "inputs", "outputs", "options")

    def __init__(self, t):
        self.opcode_index = fb.u32(t, 0)
        self.inputs = fb.vec_i32(t, 1)
        self.outputs = fb.vec_i32(t, 2)
        self.options = fb.union_table(t, 4)  # builtin_options union value


class TfliteModel:
    """Parsed .tflite: tensors, constant buffers, operator list."""

    def __init__(self, data: bytes):
        m = fb.root(data)
        # Model: version(0) operator_codes(1) subgraphs(2) description(3)
        # buffers(4)
        self.version = fb.u32(m, 0)
        self.opcodes: List[int] = []
        for i in range(fb.vec_len(m, 1)):
            oc = fb.vec_table(m, 1, i)
            # OperatorCode: deprecated_builtin_code(0, int8),
            # builtin_code(3, int32) — newer writers use slot 3
            code = fb.i32(oc, 3, 0) or fb.i8(oc, 0, 0)
            self.opcodes.append(int(code))
        if fb.vec_len(m, 2) < 1:
            raise ValueError("tflite model has no subgraph")
        g = fb.vec_table(m, 2, 0)
        # SubGraph: tensors(0) inputs(1) outputs(2) operators(3) name(4)
        self.tensors = [_Tensor(fb.vec_table(g, 0, i))
                        for i in range(fb.vec_len(g, 0))]
        self.inputs = fb.vec_i32(g, 1)
        self.outputs = fb.vec_i32(g, 2)
        self.ops = [_Op(fb.vec_table(g, 3, i))
                    for i in range(fb.vec_len(g, 3))]
        self.buffers: List[bytes] = []
        for i in range(fb.vec_len(m, 4)):
            self.buffers.append(fb.vec_bytes(fb.vec_table(m, 4, i), 0))

    def constant(self, tensor_idx: int) -> Optional[np.ndarray]:
        t = self.tensors[tensor_idx]
        raw = self.buffers[t.buffer_idx] if t.buffer_idx < len(self.buffers) \
            else b""
        if not raw:
            return None
        if t.dtype is None:
            raise ValueError(
                f"unsupported tflite tensor type code {t.type_code} "
                f"for {t.name!r}")
        arr = np.frombuffer(raw, dtype=t.dtype)
        return arr.reshape([int(s) for s in t.shape]) if t.shape else arr


class TfliteRunner:
    """Run a float .tflite model on ``device`` (nd4j-tvm/tflite runner
    role), one CUDA graph per input signature on the card.

    Usage::

        r = TfliteRunner("model.tflite", device="cuda")
        out = r.run({"input": x})      # name-keyed, or positional list
    """

    def __init__(self, model_bytes_or_path, device="cuda"):
        from ..nn.multilayer import resolve_device
        from ..runtime.inference import captured_dispatch
        self.device = resolve_device(device)
        if isinstance(model_bytes_or_path, (str, os.PathLike)):
            with open(model_bytes_or_path, "rb") as f:
                data = f.read()
        else:
            data = bytes(model_bytes_or_path)
        try:
            self.model = TfliteModel(data)
        except Exception as e:
            raise ValueError(
                f"not a parseable .tflite flatbuffer: {e}") from e
        # reject ANY quantized tensor — dynamic-range (weight-only int8)
        # models keep float inputs/outputs, so checking io alone would let
        # raw int8 weights through and silently produce garbage
        for i, t in enumerate(self.model.tensors):
            if t.quantized:
                raise ValueError(
                    f"quantized tflite models are unsupported (tensor "
                    f"{t.name!r} carries quantization scales; convert "
                    "without optimizations for float inference)")
        self.input_names = [self.model.tensors[i].name
                            for i in self.model.inputs]
        self.output_names = [self.model.tensors[i].name
                             for i in self.model.outputs]
        #: each constant buffer once on the device (host copies are
        #: re-read from the model where an op needs a static value)
        self._params: Dict[int, torch.Tensor] = {}
        for i in range(len(self.model.tensors)):
            c = self.model.constant(i)
            if c is not None:
                self._params[i] = tensor_from_numpy(c, self.device)
        self._run = captured_dispatch(self._execute, "tflite", self.device)

    # -- op lowering ------------------------------------------------------
    def _execute(self, params, *input_arrays):
        m = self.model
        env: Dict[int, object] = {}
        for idx, arr in zip(m.inputs, input_arrays):
            env[idx] = arr

        def val(i):
            """Tensor ``i``'s value: an input, an op's output (a host
            array from a SHAPE chain) or the constant on the device."""
            if i < 0:
                return None  # optional tensor slot (-1)
            if i in env:
                return env[i]
            if i not in params:
                raise ValueError(
                    f"tensor {i} ({m.tensors[i].name!r}) has no value "
                    "and no producer")
            return params[i]

        def host(i) -> Optional[np.ndarray]:
            """Tensor ``i`` as a static host value (a constant or a shape
            chain's value), None when it is a device value."""
            v = env[i] if i in env else m.constant(i)
            return None if v is None or isinstance(v, torch.Tensor) \
                else np.asarray(v)

        def static(i) -> np.ndarray:
            """An op's static argument (shape, axes, pads, bounds)."""
            v = host(i)
            if v is None:
                raise ValueError(
                    f"tensor {i} ({m.tensors[i].name!r}) must be a "
                    "constant or a shape chain's value (a static shape "
                    "argument)")
            return v

        for op in m.ops:
            code = m.opcodes[op.opcode_index]
            name = _OP_NAMES.get(code)
            if name is None:
                raise ValueError(
                    f"unsupported tflite builtin op code {code}")
            outs = self._lower(name, op, val, host, static)
            for o_idx, o_val in zip(op.outputs, outs):
                env[o_idx] = o_val
        return [self._tensor(env[i]) for i in m.outputs]

    def _tensor(self, v) -> torch.Tensor:
        return v if isinstance(v, torch.Tensor) else tensor_from_numpy(
            np.asarray(v), self.device)

    def _lower(self, name, op, val, host, static):
        o = op.options
        if name in _BINARY:
            a, b = (self._tensor(val(i)) for i in op.inputs[:2])
            out = _BINARY[name](a, b)
            fused = fb.i8(o, 0, 0) if o is not None and name in (
                "ADD", "SUB", "MUL", "DIV") else 0
            return [_apply_fused(out, fused)]
        if name == "RELU":
            return [torch.relu(val(op.inputs[0]))]
        if name == "RELU6":
            return [torch.clamp(val(op.inputs[0]), 0.0, 6.0)]
        if name == "TANH":
            return [torch.tanh(val(op.inputs[0]))]
        if name == "LOGISTIC":
            return [torch.sigmoid(val(op.inputs[0]))]
        if name == "SOFTMAX":
            beta = fb.f32(o, 0, 1.0) if o is not None else 1.0
            return [torch.softmax(val(op.inputs[0]) * beta, dim=-1)]
        if name == "FULLY_CONNECTED":
            x, w = val(op.inputs[0]), val(op.inputs[1])
            b = val(op.inputs[2]) if len(op.inputs) > 2 else None
            lead = None
            if x.dim() > 2:
                # tflite semantics: collapse to [-1, in]; leading dims are
                # restored only when keep_num_dims is set
                # (FullyConnectedOptions slot 2) — keras Dense conversions
                # set it, raw matmul collapses keep the 2-D result
                lead = tuple(x.shape[:-1])
                x = x.reshape((-1, w.shape[1]))
            out = x @ w.T  # tflite FC weights are [out, in]
            if b is not None:
                out = out + b
            keep_dims = bool(fb.i8(o, 2, 0)) if o is not None else False
            if lead is not None and keep_dims:
                out = out.reshape(lead + (w.shape[0],))
            fused = fb.i8(o, 0, 0) if o is not None else 0
            return [_apply_fused(out, fused)]
        if name in ("CONV_2D", "DEPTHWISE_CONV_2D",
                    "MAX_POOL_2D", "AVERAGE_POOL_2D") and o is None:
            raise ValueError(f"{name} without builtin options is "
                             "unsupported (stride/padding unknown)")
        if name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            x, w = val(op.inputs[0]), val(op.inputs[1])
            b = val(op.inputs[2]) if len(op.inputs) > 2 else None
            if name == "CONV_2D":
                # Conv2DOptions: padding(0) stride_w(1) stride_h(2)
                # fused(3) dil_w(4) dil_h(5); weights [out, kh, kw, in]
                pad = _padding(fb.i8(o, 0, 0))
                sw, sh = fb.i32(o, 1, 1), fb.i32(o, 2, 1)
                fused = fb.i8(o, 3, 0)
                dw, dh = fb.i32(o, 4, 1) or 1, fb.i32(o, 5, 1) or 1
                rhs = w.permute(1, 2, 3, 0)  # -> HWIO
                groups = 1
            else:
                # DepthwiseConv2DOptions: padding(0) stride_w(1)
                # stride_h(2) depth_multiplier(3) fused(4) dil_w(5)
                # dil_h(6); weights [1, kh, kw, in*mult]
                pad = _padding(fb.i8(o, 0, 0))
                sw, sh = fb.i32(o, 1, 1), fb.i32(o, 2, 1)
                mult = fb.i32(o, 3, 1) or 1
                fused = fb.i8(o, 4, 0)
                dw, dh = fb.i32(o, 5, 1) or 1, fb.i32(o, 6, 1) or 1
                cin = x.shape[-1]
                rhs = w.permute(1, 2, 0, 3).reshape(
                    w.shape[1], w.shape[2], 1, cin * mult)
                groups = cin
            out = conv_ops.conv2d(x, rhs, None, (sh, sw), pad, (dh, dw),
                                  "NHWC", groups)
            if b is not None:
                out = out + b
            return [_apply_fused(out, fused)]
        if name in ("MAX_POOL_2D", "AVERAGE_POOL_2D"):
            # Pool2DOptions: padding(0) stride_w(1) stride_h(2)
            # filter_width(3) filter_height(4) fused(5)
            x = val(op.inputs[0])
            pad = _padding(fb.i8(o, 0, 0))
            sw, sh = fb.i32(o, 1, 1), fb.i32(o, 2, 1)
            fw, fh = fb.i32(o, 3, 1), fb.i32(o, 4, 1)
            if name == "MAX_POOL_2D":
                out = conv_ops.maxpool2d(x, (fh, fw), (sh, sw), pad, "NHWC")
            else:
                # the divisor counts the window's real cells, as the JAX
                # runner's reduce_window sum over a window count of ones
                out = conv_ops.avgpool2d(x, (fh, fw), (sh, sw), pad, "NHWC",
                                         include_pad=False)
            return [_apply_fused(out, fb.i8(o, 5, 0))]
        if name == "RESHAPE":
            x = val(op.inputs[0])
            if len(op.inputs) > 1 and op.inputs[1] >= 0:
                shape = static(op.inputs[1]).astype(int).tolist()
            elif o is not None:
                shape = fb.vec_i32(o, 0)
            else:
                raise ValueError("RESHAPE without shape input or options")
            shape = [int(s) for s in shape]
            if isinstance(x, torch.Tensor):
                return [x.reshape(shape)]
            return [np.reshape(x, shape)]
        if name == "CONCATENATION":
            axis = fb.i32(o, 0, 0) if o is not None else 0
            parts = [self._tensor(val(i)) for i in op.inputs]
            out = torch.cat(parts, dim=axis)
            return [_apply_fused(out, fb.i8(o, 1, 0) if o is not None
                                 else 0)]
        if name == "MEAN":
            x = val(op.inputs[0])
            axes = tuple(int(a) for a in static(op.inputs[1]).reshape(-1))
            keep = bool(fb.i8(o, 0, 0)) if o is not None else False
            return [torch.mean(x, dim=axes, keepdim=keep)]
        if name == "PAD":
            x = val(op.inputs[0])
            pads = static(op.inputs[1]).astype(int)
            flat: List[int] = []
            for a, b in reversed(pads.tolist()):
                flat += [int(a), int(b)]
            return [torch.nn.functional.pad(x, flat)]
        if name == "TRANSPOSE":
            x = val(op.inputs[0])
            perm = [int(p) for p in static(op.inputs[1]).reshape(-1)]
            return [x.permute(perm)]
        if name == "SQUEEZE":
            x = val(op.inputs[0])
            dims = fb.vec_i32(o, 0) if o is not None else []
            if not dims:
                return [x.squeeze()]
            return [x.squeeze(tuple(int(d) for d in dims))]
        if name == "SHAPE":
            # answered on the host from the static shape, so converter-
            # emitted shape-arithmetic chains (SHAPE -> STRIDED_SLICE ->
            # PACK -> RESHAPE) stay host values inside a captured body
            return [np.asarray(tuple(val(op.inputs[0]).shape), np.int32)]
        if name == "PACK":
            # PackOptions: values_count(0) axis(1). Converter output mixes
            # scalar and [1]-shaped element tensors; normalize every part
            # to the declared element shape (output shape minus the axis)
            axis = fb.i32(o, 1, 0) if o is not None else 0
            out_shape = [int(s)
                         for s in self.model.tensors[op.outputs[0]].shape]
            elem = tuple(out_shape[:axis] + out_shape[axis + 1:])
            hosted = [host(i) for i in op.inputs]
            if all(h is not None for h in hosted):
                return [np.stack([np.reshape(h, elem) for h in hosted],
                                 axis=axis)]
            parts = [self._tensor(val(i)).reshape(elem) for i in op.inputs]
            return [torch.stack(parts, dim=axis)]
        if name == "STRIDED_SLICE":
            x = host(op.inputs[0])
            x = val(op.inputs[0]) if x is None else x
            begin = static(op.inputs[1]).astype(int)
            end = static(op.inputs[2]).astype(int)
            strides = static(op.inputs[3]).astype(int)
            # StridedSliceOptions: begin_mask(0) end_mask(1) ellipsis(2)
            # new_axis(3) shrink_axis(4)
            bm = fb.i32(o, 0, 0) if o is not None else 0
            em = fb.i32(o, 1, 0) if o is not None else 0
            sm = fb.i32(o, 4, 0) if o is not None else 0
            if o is not None and (fb.i32(o, 2, 0) or fb.i32(o, 3, 0)):
                raise ValueError(
                    "STRIDED_SLICE with ellipsis/new_axis masks is "
                    "unsupported")
            idx = []
            for d in range(len(x.shape)):
                b0 = None if (bm >> d) & 1 else int(begin[d])
                e0 = None if (em >> d) & 1 else int(end[d])
                if (sm >> d) & 1:
                    idx.append(int(begin[d]))
                else:
                    idx.append(slice(b0, e0, int(strides[d])))
            return [x[tuple(idx)]]
        raise ValueError(f"unhandled tflite op {name}")

    # -- public -----------------------------------------------------------
    def run(self, inputs) -> Dict[str, NDArray]:
        """inputs: dict keyed by tensor name, or a positional sequence."""
        if isinstance(inputs, dict):
            arrays = []
            for n, idx in zip(self.input_names, self.model.inputs):
                if n not in inputs:
                    raise KeyError(f"missing input {n!r}; model inputs: "
                                   f"{self.input_names}")
                arrays.append(inputs[n])
        else:
            arrays = list(inputs)
        if len(arrays) != len(self.model.inputs):
            raise ValueError(
                f"model takes {len(self.model.inputs)} inputs "
                f"({self.input_names}), got {len(arrays)}")
        arrays = [self._input(a) for a in arrays]
        outs = self._run(self._params, *arrays)
        return {n: NDArray(o) for n, o in zip(self.output_names, outs)}

    def _input(self, a) -> torch.Tensor:
        """One input as a tensor on the device; float64 as float32, as
        the JAX runner's ``jnp.asarray`` gives it (64-bit off)."""
        t = a.torch() if isinstance(a, NDArray) else tensor_from_numpy(
            np.asarray(a), self.device)
        if t.dtype == torch.float64:
            t = t.to(torch.float32)
        return t.to(self.device)
