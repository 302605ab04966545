"""Params -> params quantization transforms and the dequantizing ops.

Counterpart of ``deeplearning4j_tpu/quant/transforms.py``. Weight-only
PTQ, per-channel symmetric: the scale is ``absmax(W, reduction_axes) /
qmax`` (one per output channel, never per tensor) and the stored value is
``round(W / scale)`` in int8 (qmax 127) or ``W / scale`` cast to
``float8_e4m3fn`` (qmax 448). Weights stay quantized at rest — in the
params dict and in device memory — and each consumer dequantizes inside
its own op. Activations are not quantized, except on the fp8 path.

The MLP contraction of a twin, ``dequant_matmul``:

- int8: the hand-written kernel ``csrc/dequant_matmul.cu`` for CUDA
  tensors and its plain version for CPU tensors;
- fp8: the activation is scaled per tensor and cast to fp8, and the
  contraction sums in f32. The JAX package runs an XLA ``dot_general``
  there, not a Pallas kernel, so the port calls ``torch._scaled_mm`` on a
  CUDA tensor (its second operand is laid out column-major once, by
  :class:`QuantizedTensor`) and, on the CPU or where K or N is not a
  multiple of 16, the f32 product of the upcast operands;
  ``dl4j_kernel_dispatch_total{kernel="dequant_matmul_fp8"}`` says which.

Every other use of a quantized weight (the 3-D attention projections, the
tied embedding head, the embedding lookup) dequantizes with plain PyTorch
ops, as the JAX package leaves those to XLA. ``quantize_params`` reads a
``quant.calibrate.QuantSpec`` (any object with its fields will do).
"""
from __future__ import annotations

import copy
import ctypes
import dataclasses

import torch

#: saturation range of the two storage formats
_INT8_QMAX = 127.0
_FP8_QMAX = 448.0  # float8_e4m3fn finite max
_ACT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """``torch.dtype`` for a dtype name ("bfloat16", "float32", ...) or a
    dtype passed through."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name).replace("torch.", ""))


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def default_act_dtype(device) -> str:
    """Activation dtype of a quantized twin when the spec leaves it to
    the platform: bf16 on a CUDA device (the tensor cores' type), f32 on
    the CPU."""
    return "bfloat16" if torch.device(device).type == "cuda" else "float32"


def fp8_supported(device=None) -> bool:
    """Whether fp8 quantization can run here: ``torch.float8_e4m3fn``
    exists and, on a CUDA device (``device``, else the current one when a
    card is present), its compute capability is at least 8.9 (Ada,
    Hopper). A CPU device takes the f32-upcast product and needs only the
    dtype."""
    if not hasattr(torch, "float8_e4m3fn"):
        return False
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return True
    return torch.cuda.get_device_capability(device) >= (8, 9)


def _is_fp8_matmul_weight(q, scale) -> bool:
    """A 2-D fp8 payload with one scale per output channel: the weight
    :func:`dequant_matmul` hands to ``torch._scaled_mm``."""
    return ("float8" in str(q.dtype) and q.dim() == 2
            and scale.dim() == 2 and scale.shape[0] == 1)


class QuantizedTensor:
    """One quantized weight: ``q`` (int8 or fp8, full shape) + ``scale``
    (f32, keepdims-broadcast over the reduction axes). Dequantized value
    is ``q * scale`` in f32, cast to the consumer's compute dtype.

    A per-output-channel 2-D fp8 ``q`` is laid out column-major here, once
    (``torch._scaled_mm`` wants its second operand so), whoever builds the
    weight; every other ``q`` is kept as given."""

    __slots__ = ("q", "scale", "orig_dtype")

    def __init__(self, q, scale, orig_dtype: str = "float32"):
        if _is_fp8_matmul_weight(q, scale) and q.stride(0) != 1:
            q = q.t().contiguous().t()
        self.q = q
        self.scale = scale
        self.orig_dtype = dtype_name(torch_dtype(orig_dtype))

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.dim()

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def device(self):
        return self.q.device

    def numel(self) -> int:
        return self.q.numel()

    @property
    def nbytes(self) -> int:
        return int(self.q.nbytes) + int(self.scale.nbytes)

    def astype(self, dtype):
        """No-op: quantized storage is compute-dtype-invariant — the cast
        happens at dequantization, inside the consuming op."""
        return self

    def to(self, device):
        return QuantizedTensor(self.q.to(device), self.scale.to(device),
                               self.orig_dtype)

    @property
    def mode(self) -> str:
        return "fp8" if "float8" in str(self.q.dtype) else "int8"

    # -- under a partition spec (common/mesh.py's place / gather) --------
    def _scale_spec(self, spec):
        """``spec`` for the scale: a dim on which the keepdims scale has
        size 1 (a reduction axis) stays whole."""
        from ..common.mesh import P
        return P(*(e if d < self.scale.dim() and self.scale.shape[d] != 1
                   else None for d, e in enumerate(spec)))

    def placed(self, mesh, spec):
        """This rank's shard under ``spec`` (with the divisibility
        fallback): ``q`` sliced on the sharded dims, the scale with it
        where it has that dim (:meth:`_scale_spec`). Each part is
        contiguous, so the dequant-matmul kernel reads the slice as it
        is."""
        from ..common.mesh import place, placement, tag, valid_spec
        spec = valid_spec(mesh, spec, self.q.shape)
        q = place(self.q, mesh, spec)
        out = QuantizedTensor(q, place(self.scale, mesh,
                                       self._scale_spec(spec)),
                              self.orig_dtype)
        if out.q is not q:               # an fp8 weight laid out anew
            tag(out.q, *placement(q))
        return out

    def sliced(self, mesh, spec):
        """This rank's views of a whole (global) quantized weight under
        ``spec``, tagged as :meth:`placed` tags its copies."""
        from ..common.mesh import local_slice, tag, valid_spec
        spec = valid_spec(mesh, spec, self.q.shape)
        sspec = self._scale_spec(spec)
        q = tag(local_slice(self.q, mesh, spec), mesh, spec, self.q.shape)
        scale = tag(local_slice(self.scale, mesh, sspec), mesh, sspec,
                    self.scale.shape)
        return QuantizedTensor(q, scale, self.orig_dtype)

    def gathered(self):
        """The global weight of a placed one (every rank of its mesh
        calls it)."""
        from ..common.mesh import gather
        return QuantizedTensor(gather(self.q), gather(self.scale),
                               self.orig_dtype)

    def __repr__(self):
        return (f"QuantizedTensor(shape={tuple(self.shape)}, "
                f"mode={self.mode}, scale={tuple(self.scale.shape)})")


def quantize_tensor(w, axes=None, mode: str = "int8") -> QuantizedTensor:
    """Per-channel symmetric quantization of one weight. ``axes`` are the
    reduction axes of the absmax (default: every axis but the last, one
    scale per output channel; embedding tables pass ``range(1, ndim)``
    for per-row scales). int8 rounds half to even, as ``jnp.round``; the
    fp8 cast rounds to nearest even, as ``jnp.astype``; so ``q`` is
    bit-identical to the JAX package's either way."""
    if isinstance(w, QuantizedTensor):
        return w
    orig = dtype_name(w.dtype)
    w32 = w.float()
    if axes is None:
        axes = tuple(range(w32.dim() - 1))
    axes = tuple(axes)
    amax = torch.clamp_min(torch.amax(w32.abs(), dim=axes, keepdim=True),
                           1e-12)
    if mode == "int8":
        scale = amax / _INT8_QMAX
        q = torch.clamp(torch.round(w32 / scale),
                        -_INT8_QMAX, _INT8_QMAX).to(torch.int8)
    elif mode == "fp8":
        if not fp8_supported(w.device):
            raise ValueError(
                f"fp8 quantization requested but fp8_supported({w.device})"
                " is False (needs torch.float8_e4m3fn and, on CUDA, "
                "compute capability 8.9 or later)")
        scale = amax / _FP8_QMAX
        q = (w32 / scale).to(torch.float8_e4m3fn)
    else:
        raise ValueError(f"unknown quantization mode {mode!r} "
                         "(expected 'int8' or 'fp8')")
    return QuantizedTensor(q, scale, orig_dtype=orig)


def dequantize(w, dtype=None):
    """``w`` as a plain tensor in ``dtype`` (f32 dequant, then cast).
    Plain tensors pass through (cast only when a dtype is given)."""
    if not isinstance(w, QuantizedTensor):
        return w if dtype is None else w.to(dtype)
    out = w.q.float() * w.scale
    return out.to(dtype if dtype is not None else torch_dtype(w.orig_dtype))


# -- the fused int8 dequant-matmul (kernel 2) ------------------------------

def dequant_matmul_plain(x2, q, scale):
    """``(x2 @ q) * scale`` computed as the fused kernel computes it: the
    int8 weight widened exactly, the product summed in f32, the
    per-channel scale on the f32 sum, one cast to ``x2``'s dtype. ``x2``
    [M, K], ``q`` [K, N] int8, ``scale`` [N] f32."""
    return (torch.matmul(x2.float(), q.float()) * scale).to(x2.dtype)


_lib = None


def _kernel():
    """The loaded ``csrc/dequant_matmul.cu`` library with its argument
    types set (built at first use)."""
    global _lib
    if _lib is None:
        from ..kernels import _build
        lib = _build.load("dequant_matmul")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.dequant_matmul.argtypes = [P] * 5 + [I] * 4 + [P]
        lib.dequant_matmul.restype = I
        lib.dequant_matmul_workspace_bytes.argtypes = [I] * 4
        lib.dequant_matmul_workspace_bytes.restype = ctypes.c_longlong
        lib.dequant_matmul_crossover_m.restype = I
        lib.dequant_matmul_whole_k_max_m.restype = I
        _lib = lib
    return _lib


def _check_kernel_args(x2, q, scale):
    if x2.dtype not in (torch.float32, torch.bfloat16) \
            or q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"dequant_matmul: the kernel takes f32/bf16 x, "
                        f"int8 q and f32 scale, got {x2.dtype}/{q.dtype}/"
                        f"{scale.dtype}")


def _launch(x2, q, scale):
    """One launch of the kernel library (its split-K pass included) into a
    new output, on the library's own plan by M. The f32 split-K workspace
    comes from ``torch.empty``, sized by host arithmetic on the shapes, so
    nothing waits on the device."""
    from ..kernels import _build
    x2, q, scale = x2.contiguous(), q.contiguous(), scale.contiguous()
    M, K = x2.shape
    N = q.shape[1]
    bf16 = x2.dtype == torch.bfloat16
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    lib = _kernel()
    nbytes = lib.dequant_matmul_workspace_bytes(M, K, N, int(bf16))
    ws = torch.empty((nbytes + 3) // 4, dtype=torch.float32,
                     device=x2.device) if nbytes > 0 else None
    args = (x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    status = lib.dequant_matmul(*args, M, K, N, int(bf16), stream)
    _build.check(lib, status, "dequant_matmul")
    return out


def crossover_m() -> int:
    """The largest M the kernel library runs on its split-K small-M
    design; larger M takes the 128 x 128 tiles (bf16) unless the whole-K
    design takes it (see :func:`whole_k_max_m`)."""
    return _kernel().dequant_matmul_crossover_m()


def whole_k_max_m() -> int:
    """The largest M the kernel library runs on its whole-K small-M
    design, where N is wide enough for it."""
    return _kernel().dequant_matmul_whole_k_max_m()


def _fused_dequant_matmul(x2, q, scale):
    """The int8 weight-stationary ``[M,K] @ [K,N]`` with the per-channel
    scale applied to the f32 sum after the last K slice. CUDA tensors
    launch ``csrc/dequant_matmul.cu`` (or raise); CPU tensors take
    :func:`dequant_matmul_plain`."""
    M, K = x2.shape
    if q.dim() != 2 or q.shape[0] != K or scale.shape != (q.shape[1],):
        raise ValueError(f"dequant_matmul: x {tuple(x2.shape)}, q "
                         f"{tuple(q.shape)}, scale {tuple(scale.shape)} "
                         "do not line up")
    if len({x2.device, q.device, scale.device}) != 1:
        raise ValueError("dequant_matmul: x, q and scale must be on one "
                         "device")
    if not x2.is_cuda:
        return dequant_matmul_plain(x2, q, scale)
    from ..kernels._counts import count_launch
    _check_kernel_args(x2, q, scale)
    out = _launch(x2, q, scale)
    count_launch(_fused_dequant_matmul)
    return out


#: kernel launches since the count was last set to 0
_fused_dequant_matmul.launches = 0


# -- the fp8 branch (an XLA dot_general in the JAX package) -----------------

def fp8_matmul_plain(xq, wq, sx, out_scale):
    """The fp8 contraction computed from its f32-upcast operands: exact
    per product (fp8 x fp8 fits f32), summed in f32, then scaled by
    ``sx * out_scale``. ``xq`` [M, K] and ``wq`` [K, N] fp8, ``sx`` the
    activation's scale (a 0-d tensor), ``out_scale`` [N] f32; f32 out."""
    return torch.matmul(xq.float(), wq.float()) * (sx * out_scale)


#: (K, N) granularity torch._scaled_mm takes
_SCALED_MM_ALIGN = 16


def _fp8_route(x2, wq):
    """("scaled_mm", "") for a CUDA activation whose K and N
    ``torch._scaled_mm`` takes, else ("plain", why)."""
    K, N = wq.shape
    if not x2.is_cuda:
        return "plain", f"{x2.device.type} tensor (_scaled_mm runs on CUDA)"
    if K % _SCALED_MM_ALIGN or N % _SCALED_MM_ALIGN:
        return "plain", (f"K={K} N={N} not multiples of "
                         f"{_SCALED_MM_ALIGN} (_scaled_mm's granularity)")
    return "scaled_mm", ""


def _fp8_dequant_matmul(x, w):
    """``x @ W`` for a per-output-channel fp8 ``W``: the activation is
    scaled per tensor (``sx = amax|x| / 448``, in ``x``'s dtype) and cast
    to fp8, the product sums in f32, and the result is scaled by ``sx *
    out_scale`` and cast to ``x``'s dtype, as in the JAX package."""
    from ..kernels import kernel_dispatch
    out_scale = w.scale.reshape(-1)
    sx = torch.clamp_min(torch.amax(x.abs()), 1e-12) / _FP8_QMAX
    x2 = (x / sx).to(w.q.dtype).reshape(-1, x.shape[-1])
    route, why = _fp8_route(x2, w.q)
    kernel_dispatch("dequant_matmul_fp8", route, why)
    if route == "scaled_mm":
        if w.q.stride(0) != 1:
            raise ValueError(f"dequant_matmul: the fp8 weight has strides "
                             f"{w.q.stride()}; QuantizedTensor lays it out "
                             "column-major for torch._scaled_mm")
        one = torch.ones((), dtype=torch.float32, device=x.device)
        out = torch._scaled_mm(x2, w.q,
                               scale_a=sx.float(), scale_b=one,
                               out_dtype=torch.float32)
        if isinstance(out, tuple):   # older torch returns (out, amax)
            out = out[0]
        out = out * out_scale
    else:
        out = fp8_matmul_plain(x2, w.q, sx, out_scale)
    return out.to(x.dtype).reshape(tuple(x.shape[:-1]) + (w.q.shape[1],))


def dequant_matmul(x, w):
    """``x @ W`` with int8/fp8-at-rest ``W`` (last-dim contraction, any
    leading ``x`` dims). A per-output-channel 2-D int8 weight goes
    through the fused kernel on CUDA and its plain version on the CPU; a
    2-D fp8 weight through :func:`_fp8_dequant_matmul`; any other
    quantized weight is dequantized first; plain tensors pass straight to
    ``torch.matmul`` so one code path serves every precision."""
    if not isinstance(w, QuantizedTensor):
        return torch.matmul(x, w)
    if w.ndim != 2 or w.scale.shape[0] != 1:
        # not a per-output-channel 2D weight: dequantize then contract
        return torch.matmul(x, dequantize(w, x.dtype))
    if w.mode == "fp8":
        return _fp8_dequant_matmul(x, w)
    from ..kernels import kernel_dispatch
    if x.is_cuda:
        kernel_dispatch("dequant_matmul", "fused")
    else:
        kernel_dispatch("dequant_matmul", "plain",
                        f"{x.device.type} tensor (the kernel runs on CUDA)")
    x2 = x.reshape(-1, x.shape[-1])
    out = _fused_dequant_matmul(x2, w.q, w.scale.reshape(-1))
    return out.reshape(tuple(x.shape[:-1]) + (w.q.shape[1],))


def take_rows(w, ids, dtype=None):
    """Row lookup through a per-row-scaled quantized table: gather the
    int8 rows AND their scales, multiply."""
    ids = ids.long()
    if not isinstance(w, QuantizedTensor):
        out = w[ids]
        return out if dtype is None else out.to(dtype)
    rows = w.q[ids].float()
    scales = w.scale[ids]
    return (rows * scales).to(dtype if dtype is not None
                              else torch_dtype(w.orig_dtype))


def tied_logits(h, w):
    """Tied word-embedding head ``einsum('...e,ve->...v')`` in f32
    against a per-row-scaled quantized table: the row scale is the
    output-channel scale of the transposed contraction."""
    if not isinstance(w, QuantizedTensor):
        return torch.einsum("...e,ve->...v", h, w).float()
    out = torch.einsum("...e,ve->...v", h, w.q.to(h.dtype)).float()
    return out * w.scale.reshape(-1)


# -- params -> params recipes ----------------------------------------------

def _spec_field(spec, name, default):
    # a QuantSpec, or any object with its fields (None = the defaults)
    return getattr(spec, name, default) if spec is not None else default


def quantize_params(params, spec=None):
    """Quantize every eligible weight leaf of a params tree, preserving
    structure. Eligible: floating, ndim >= 2, ``numel >= spec.min_size``,
    key not in ``spec.skip_keys`` and not a ``state_*`` running stat.
    Keys in ``spec.embedding_keys`` get per-row scales; everything else
    per-output-channel. ``spec.scale_overrides`` maps a path substring to
    a multiplier on the matching tensors' scales."""
    mode = _spec_field(spec, "mode", "int8")
    min_size = int(_spec_field(spec, "min_size", 256))
    skip = tuple(_spec_field(spec, "skip_keys", ("position", "token_type")))
    emb = tuple(_spec_field(spec, "embedding_keys", ("word",)))
    overrides = dict(_spec_field(spec, "scale_overrides", {}) or {})

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            seq = [walk(v, path + (str(i),)) for i, v in enumerate(node)]
            return seq if isinstance(node, list) else tuple(seq)
        if isinstance(node, QuantizedTensor):
            return node
        key = path[-1] if path else ""
        if (not isinstance(node, torch.Tensor)
                or not node.is_floating_point()
                or node.dim() < 2 or node.numel() < min_size
                or key in skip or key.startswith("state_")):
            return node
        axes = (tuple(range(1, node.dim())) if key in emb
                else tuple(range(node.dim() - 1)))
        qt = quantize_tensor(node, axes=axes, mode=mode)
        dotted = ".".join(path)
        for frag, factor in overrides.items():
            if frag in dotted:
                qt = QuantizedTensor(qt.q, qt.scale * float(factor),
                                     orig_dtype=qt.orig_dtype)
        return qt

    return walk(params, ())


def _to_device(node, device):
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        seq = [_to_device(v, device) for v in node]
        return seq if isinstance(node, list) else tuple(seq)
    if isinstance(node, (torch.Tensor, QuantizedTensor)):
        return node.to(device)
    return node


def _resolved_act(spec, device):
    act = _spec_field(spec, "act_dtype", None) or default_act_dtype(device)
    if str(act) not in _ACT_DTYPES:
        raise ValueError(f"act_dtype {act!r} is not one of "
                         f"{sorted(_ACT_DTYPES)}")
    return str(act)


def quantize_model(model, spec=None, *, device="cuda"):
    """An inference-only int8/fp8 twin of ``model`` on ``device``, over
    quantized params, computing in the activation dtype
    (``spec.act_dtype``, else bf16 on CUDA and f32 on the CPU):

    - a CausalLM-protocol model (``init_kv_cache``/``prefill``/``decode``
      + ``params``/``config``): a new instance of the same class, config
      dtype flipped to the activation dtype (the KV pool follows it);
    - a layer-API network (``conf`` + ``_params``): a network of the same
      class over the same layer configs, conf dtype flipped, no updater
      state; its dense layers contract through :func:`dequant_matmul`
      (the int8 kernel on the card) and its loss head stays f32;
    - a bare params tree: ``quantize_params`` of it.

    The original is not modified."""
    if all(callable(getattr(model, m, None))
           for m in ("init_kv_cache", "prefill", "decode")) \
            and hasattr(model, "params") and hasattr(model, "config"):
        act = _resolved_act(spec, device)
        qp = _to_device(quantize_params(model.params, spec), device)
        cfg = dataclasses.replace(model.config, dtype=_ACT_DTYPES[act])
        twin = type(model)(cfg, params=qp, device=device)
        twin._precision = precision_of(qp)
        return twin
    if hasattr(model, "_params") and hasattr(model, "conf"):
        twin = type(model)(copy.copy(model.conf), device=device)
        twin.conf.dtype = _resolved_act(spec, device)
        twin._params = _to_device(quantize_params(model._params, spec),
                                  device)
        twin._updater_state = None  # inference-only: no optimizer state
        twin._initialized = True
        twin._precision = precision_of(twin._params)
        return twin
    if isinstance(model, (dict, list)):
        return _to_device(quantize_params(model, spec), device)
    raise TypeError(
        f"don't know how to quantize {type(model).__name__}: expected a "
        "CausalLM-protocol model, a layer-API network (conf + _params), "
        "or a bare params tree")


# -- introspection ---------------------------------------------------------

def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def precision_of(params) -> str:
    """Dominant storage precision of a params tree: ``int8``/``fp8`` when
    any leaf is quantized, else the widest floating dtype seen."""
    seen = set()
    for leaf in _leaves(params):
        if isinstance(leaf, QuantizedTensor):
            return leaf.mode
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            seen.add(dtype_name(leaf.dtype))
    for dt in ("float64", "float32", "bfloat16", "float16"):
        if dt in seen:
            return dt
    return "float32"


def _params_of(model):
    """The params tree of a model (``params``), a layer-API network
    (``_params``; its ``params()`` is the flat vector) or a bare tree."""
    p = getattr(model, "params", None)
    if p is not None and not callable(p):
        return p
    if hasattr(model, "_params"):
        return model._params
    return model if isinstance(model, (dict, list)) else None


def precision_of_model(model) -> str:
    p = _params_of(model)
    return precision_of(p) if p is not None else "float32"


def param_bytes(params) -> int:
    """At-rest parameter bytes (quantized leaves count q + scale)."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, (QuantizedTensor, torch.Tensor)):
            total += int(leaf.nbytes)
    return total


def param_bytes_of(model) -> int:
    p = _params_of(model)
    return param_bytes(p) if p is not None else 0
