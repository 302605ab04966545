"""SameDiff: the define-then-run autodiff graph.

Counterpart of ``deeplearning4j_tpu/autodiff/samediff.py`` (the
reference's ``SameDiff.java`` and ``SDVariable.java``). A graph is a
recorded program of registered ops (``ops/``) over named variables:
VARIABLE (trainable), CONSTANT, PLACEHOLDER and ARRAY (an op's output).

The JAX package traces the recorded program once into an XLA
computation; the port interprets it eagerly, op by op, on the graph's
device (the card unless the caller names another), as the reference's
session does:

- ``output`` runs the ops the requested variables need under
  ``torch.no_grad()`` and the port's ``full_f32()`` (an f32 product on
  the card computes in f32, not TF32), through ``make_function``'s
  callable, which the dispatch census counts once per new placeholder
  signature (tag ``sd:...``). A batch is padded up the inference bucket
  ladder where one run of the graph on ``meta`` tensors, at the exact
  and the padded shape, proves that every requested output keeps the
  batch axis; anything else (an exception included) takes the exact
  shape, as the JAX package's ``jax.eval_shape`` proof does.
- ``calculate_gradients`` and ``fit`` (``training.py``) differentiate the
  interpreted forward with autograd.

Placeholders given as numpy arrays or CPU tensors move to the graph's
device; host data is narrowed to 32 bits (float64 -> float32, int64 ->
int32), as ``jnp.asarray`` does with 64-bit types off.
"""
from __future__ import annotations

import enum
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..common import rng as _rng
from ..ndarray.ndarray import NDArray
from ..nn.fit_fastpath import full_f32
from ..nn.multilayer import resolve_device
from ..ops import OpRegistry
from ..ops._util import dtype_of, narrow


class VariableType(enum.Enum):
    VARIABLE = "VARIABLE"      # trainable parameter
    CONSTANT = "CONSTANT"
    PLACEHOLDER = "PLACEHOLDER"
    ARRAY = "ARRAY"            # op output


def dtype_name(t: torch.Tensor) -> str:
    """``"float32"``, ``"bfloat16"``, ...: the JAX package's spelling."""
    return str(t.dtype).replace("torch.", "")


def to_tensor(value, device=None) -> torch.Tensor:
    """An NDArray, tensor, numpy array (bf16 bit-exact, ``bridge``) or
    Python value as a tensor on ``device``; host data narrowed to 32
    bits."""
    if isinstance(value, NDArray):
        value = value.torch()
    if isinstance(value, torch.Tensor):
        t = value
    else:
        from ..bridge import tensor_from_numpy
        t = tensor_from_numpy(np.asarray(value), "cpu")
        t = t.to(narrow(t.dtype))
    return t.to(device) if device is not None and t.device != device else t


class SDVariable:
    """Symbolic variable handle (reference SDVariable.java).

    Arithmetic on SDVariables records ops into the owning SameDiff graph.
    """

    def __init__(self, sd: "SameDiff", name: str, var_type: VariableType,
                 shape: Optional[Tuple[int, ...]] = None,
                 dtype: str = "float32"):
        self.sd = sd
        self.name = name
        self.var_type = var_type
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype

    # -- graph-building arithmetic --------------------------------------
    def _bin(self, other, op_name):
        other = self.sd._as_var(other)
        return self.sd._record(op_name, [self, other])

    def __add__(self, o): return self._bin(o, "add")
    def __radd__(self, o): return self.sd._as_var(o)._bin(self, "add")
    def __sub__(self, o): return self._bin(o, "subtract")
    def __rsub__(self, o): return self.sd._as_var(o)._bin(self, "subtract")
    def __mul__(self, o): return self._bin(o, "multiply")
    def __rmul__(self, o): return self.sd._as_var(o)._bin(self, "multiply")
    def __truediv__(self, o): return self._bin(o, "divide")
    def __rtruediv__(self, o): return self.sd._as_var(o)._bin(self, "divide")
    def __pow__(self, o): return self._bin(o, "Pow")
    def __neg__(self): return self.sd._record("neg", [self])
    def __matmul__(self, o): return self._bin(o, "matmul")

    def add(self, o): return self.__add__(o)
    def sub(self, o): return self.__sub__(o)
    def mul(self, o): return self.__mul__(o)
    def div(self, o): return self.__truediv__(o)
    def mmul(self, o): return self._bin(o, "matmul")
    def dot(self, o): return self._bin(o, "dot")

    # comparisons record ops (python == stays identity so vars stay hashable)
    def __lt__(self, o): return self._bin(o, "less")
    def __le__(self, o): return self._bin(o, "less_equal")
    def __gt__(self, o): return self._bin(o, "greater")
    def __ge__(self, o): return self._bin(o, "greater_equal")
    def eq(self, o): return self._bin(o, "equals")
    def neq(self, o): return self._bin(o, "not_equals")
    def lt(self, o): return self.__lt__(o)
    def lte(self, o): return self.__le__(o)
    def gt(self, o): return self.__gt__(o)
    def gte(self, o): return self.__ge__(o)

    def __getitem__(self, idx):
        # basic indexing lowers to the serializable tf_strided_slice op
        if isinstance(idx, SDVariable):
            return self.sd._record("gather", [self, idx], axis=0)
        if not isinstance(idx, tuple):
            idx = (idx,)
        spec = []
        for e in idx:
            if isinstance(e, slice):
                if e.start is None and e.stop is None and e.step is None:
                    spec.append(("all",))
                else:
                    spec.append(("slice", e.start, e.stop, e.step or 1))
            elif e is Ellipsis:
                spec.append(("ellipsis",))
            elif e is None:
                spec.append(("newaxis",))
            elif isinstance(e, (int, np.integer)):
                spec.append(("int", int(e)))
            else:
                raise TypeError(f"unsupported index element {e!r}")
        return self.sd._record("tf_strided_slice", [self], spec=spec)

    # common methods routed through the op registry
    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self.sd._record("reshape", [self], shape=shape)

    def transpose(self, *axes):
        return self.sd._record("transpose", [self],
                               axes=axes if axes else None)

    def sum(self, *dims, keep_dims=False):
        return self.sd._record("reduce_sum", [self], dims=dims or None,
                               keep_dims=keep_dims)

    def mean(self, *dims, keep_dims=False):
        return self.sd._record("reduce_mean", [self], dims=dims or None,
                               keep_dims=keep_dims)

    def max(self, *dims, keep_dims=False):
        return self.sd._record("reduce_max", [self], dims=dims or None,
                               keep_dims=keep_dims)

    def min(self, *dims, keep_dims=False):
        return self.sd._record("reduce_min", [self], dims=dims or None,
                               keep_dims=keep_dims)

    def std(self, *dims, keep_dims=False):
        return self.sd._record("reduce_stdev", [self], dims=dims or None,
                               keep_dims=keep_dims)

    def argmax(self, dim=None):
        return self.sd._record("argmax", [self], dims=dim)

    def norm2(self, *dims):
        return self.sd._record("reduce_norm2", [self], dims=dims or None)

    def cast(self, dtype):
        return self.sd._record("cast", [self], dtype=dtype)

    def rank(self):
        return self.sd._record("rank", [self])

    # -- evaluation ------------------------------------------------------
    def eval(self, placeholders: Dict[str, Any] = None) -> NDArray:
        """Execute the graph up to this variable (reference
        SDVariable.eval)."""
        return self.sd.output(placeholders or {}, [self.name])[self.name]

    def get_arr(self) -> Optional[NDArray]:
        return self.sd.get_arr_for_var(self.name)

    def set_array(self, value):
        self.sd.set_array(self.name, value)

    def rename(self, new_name: str) -> "SDVariable":
        self.sd.rename_variable(self.name, new_name)
        return self

    def __repr__(self):
        return (f"SDVariable(name={self.name!r}, type={self.var_type.value}, "
                f"shape={self.shape}, dtype={self.dtype})")


class TensorArray:
    """Functional TensorArray (reference TensorArray ops).

    Writes rebind the backing SDVariable (``scatter_upd`` on a dense
    backing array), matching the reference's mutate-in-session semantics
    at the API level. For trainable accumulation loops prefer
    ``sd.scan``."""

    def __init__(self, sd: "SameDiff", size: int, element_shape, dtype):
        self.sd = sd
        self.size_ = int(size)
        self.element_shape = tuple(element_shape)
        self._var = sd.constant(
            np.zeros((self.size_,) + self.element_shape, dtype), "ta")

    def write(self, index: int, value) -> "TensorArray":
        v = self.sd._as_var(value)
        expanded = self.sd._record("expand_dims", [v], axis=0)
        self._var = self.sd._record("scatter_upd",
                                    [self._var,
                                     self.sd.constant(
                                         np.asarray([index], np.int32)),
                                     expanded])
        return self

    def read(self, index: int) -> "SDVariable":
        return self.sd._record("tf_strided_slice", [self._var],
                               spec=[("int", int(index))])

    def stack(self) -> "SDVariable":
        return self.sd._record("identity", [self._var])

    def unstack(self, value) -> "TensorArray":
        self._var = self.sd._as_var(value)
        return self

    def size(self) -> int:
        return self.size_


class SameDiffOp:
    """A recorded graph node (reference internal/SameDiffOp.java)."""

    __slots__ = ("name", "op_name", "fn", "inputs", "outputs", "kwargs",
                 "needs_key")

    def __init__(self, name, op_name, fn, inputs, outputs, kwargs,
                 needs_key=False):
        self.name = name
        self.op_name = op_name
        self.fn = fn
        self.inputs = inputs       # list[str] variable names
        self.outputs = outputs     # list[str] variable names
        self.kwargs = kwargs
        self.needs_key = needs_key  # op consumes a random key (dropout etc.)


def run_node(fn, args, kwargs, device):
    """One op: a node with no tensor input (a constructor) makes its
    tensors on ``device``."""
    if device is not None and not any(isinstance(a, torch.Tensor)
                                      for a in args):
        with torch.device(device):
            return fn(*args, **kwargs)
    return fn(*args, **kwargs)


class SameDiff:
    """The define-then-run graph container and interpreter.

    Usage mirrors the reference:
        sd = SameDiff.create()                  # on the card
        x = sd.placeholder("x", (None, 784))
        w = sd.var("w", nd.randn(784, 10))
        out = sd.nn.softmax(x.mmul(w))
        result = out.eval({"x": batch})
    """

    def __init__(self, eager: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self._vars: Dict[str, SDVariable] = {}
        self._arrays: Dict[str, torch.Tensor] = {}  # VARIABLE/CONSTANT values
        self._ops: Dict[str, SameDiffOp] = {}
        self._op_order: List[str] = []
        self._producer: Dict[str, Tuple[str, int]] = {}  # var -> (op, out)
        self._name_counter = 0
        self._scope: List[str] = []
        self._fn_cache: Dict[Any, Callable] = {}
        self._loss_variables: List[str] = []
        self.training_config = None
        self._updater_state = None
        self._listeners: List[Any] = []
        self._rng_seed = 0
        self._iteration = 0
        # eager mode (reference SameDiff.java eagerMode): ops also execute
        # as they are recorded, on the arrays known then; a debugging aid,
        # the define-then-run path is unchanged
        self._eager = bool(eager)
        self._eager_vals: Dict[str, torch.Tensor] = {}
        self._eager_gen: Optional[torch.Generator] = None

    # ------------------------------------------------------------------
    @staticmethod
    def create(eager: bool = False, device="cuda") -> "SameDiff":
        return SameDiff(eager=eager, device=device)

    def _tensor(self, value) -> torch.Tensor:
        return to_tensor(value, self.device)

    # -- eager mode ------------------------------------------------------
    def enable_eager_mode(self):
        """Execute each op as it is defined (reference enableEagerMode)."""
        self._eager = True
        return self

    def is_eager_mode(self) -> bool:
        return self._eager

    def _try_eager(self, node: SameDiffOp) -> None:
        """Run a just-recorded node on concrete arrays if every input has
        one (VARIABLE/CONSTANT values, placeholder arrays set via
        set_array, or earlier eager results). Failures are non-fatal: the
        graph records regardless; eval()/output() recompute properly."""
        vals = []
        for name in node.inputs:
            if name is None:
                vals.append(None)
                continue
            v = self._eager_vals.get(name)
            if v is None:
                v = self._arrays.get(name)
            if v is None:
                return  # e.g. placeholder with no array yet
            vals.append(v)
        kwargs = dict(node.kwargs)
        if node.needs_key:
            if self._eager_gen is None:
                self._eager_gen = torch.Generator().manual_seed(
                    self._rng_seed)
            kwargs["key"] = _rng.split(self._eager_gen)
        try:
            with torch.no_grad():
                result = run_node(node.fn, vals, kwargs, self.device)
        except Exception:
            return
        self._bind_outputs(node, result, self._eager_vals)

    @staticmethod
    def _bind_outputs(node: SameDiffOp, result, env: Dict[str, Any]):
        """Store an op's result under its declared output names, raising on
        any arity mismatch (a silent zip would slice rows instead)."""
        if len(node.outputs) == 1:
            if isinstance(result, (tuple, list)):
                raise ValueError(
                    f"op '{node.name}' ({node.op_name}) declares 1 output "
                    f"but returned {len(result)} values; record it with "
                    f"n_outputs={len(result)}")
            env[node.outputs[0]] = result
        else:
            if (not isinstance(result, (tuple, list))
                    or len(result) != len(node.outputs)):
                got = (len(result) if isinstance(result, (tuple, list))
                       else f"a single {type(result).__name__}")
                raise ValueError(
                    f"op '{node.name}' ({node.op_name}) declares "
                    f"{len(node.outputs)} outputs but returned {got}")
            for oname, r in zip(node.outputs, result):
                env[oname] = r

    def eager_arr(self, name: str) -> Optional[NDArray]:
        """The eagerly computed value for a variable, if one exists."""
        v = self._eager_vals.get(name)
        return NDArray(v) if v is not None else None

    # -- naming ----------------------------------------------------------
    def _unique_name(self, base: str) -> str:
        name = "/".join(self._scope + [base]) if self._scope else base
        if name not in self._vars and name not in self._ops:
            return name
        while True:
            self._name_counter += 1
            cand = f"{name}_{self._name_counter}"
            if cand not in self._vars and cand not in self._ops:
                return cand

    def name_scope(self, name: str):
        sd = self

        class _Scope:
            def __enter__(self):
                sd._scope.append(name)
                return sd

            def __exit__(self, *a):
                sd._scope.pop()

        return _Scope()

    # -- variable creation ----------------------------------------------
    def var(self, name: str, value=None, shape=None, dtype="float32",
            initializer=None) -> SDVariable:
        """Trainable VARIABLE (reference SameDiff.var)."""
        name = self._unique_name(name)
        if value is not None:
            arr = self._tensor(value)
        elif initializer is not None:
            arr = self._tensor(initializer(shape))
        else:
            arr = torch.zeros(tuple(shape), dtype=dtype_of(dtype),
                              device=self.device)
        v = SDVariable(self, name, VariableType.VARIABLE, tuple(arr.shape),
                       dtype_name(arr))
        self._vars[name] = v
        self._arrays[name] = arr
        return v

    def constant(self, value, name: str = "const") -> SDVariable:
        name = self._unique_name(name)
        arr = self._tensor(value)
        v = SDVariable(self, name, VariableType.CONSTANT, tuple(arr.shape),
                       dtype_name(arr))
        self._vars[name] = v
        self._arrays[name] = arr
        return v

    def placeholder(self, name: str, shape=None,
                    dtype="float32") -> SDVariable:
        name = self._unique_name(name)
        v = SDVariable(self, name, VariableType.PLACEHOLDER,
                       tuple(shape) if shape else None, dtype)
        self._vars[name] = v
        return v

    # aliases matching the reference API
    def variable(self, *a, **k):
        return self.var(*a, **k)

    def one(self, name, shape):
        return self.constant(torch.ones(tuple(shape)), name)

    def zero(self, name, shape):
        return self.constant(torch.zeros(tuple(shape)), name)

    # -- graph recording -------------------------------------------------
    def _as_var(self, x) -> SDVariable:
        if isinstance(x, SDVariable):
            return x
        return self.constant(x)

    def _record(self, op_name: str, inputs: Sequence[SDVariable],
                n_outputs: int = 1, out_name: str = None,
                out_names: Sequence[str] = None, **kwargs) -> Union[
                    SDVariable, Tuple[SDVariable, ...]]:
        """Record a registered op as a graph node."""
        opdef = OpRegistry.get().lookup(op_name)
        OpRegistry.get().mark_executed(opdef.name)
        return self._record_fn(opdef.fn, inputs, label=op_name,
                               n_outputs=n_outputs, out_name=out_name,
                               out_names=out_names, **kwargs)

    def _record_fn(self, fn: Callable, inputs: Sequence[SDVariable],
                   label: str = "fn", n_outputs: int = 1,
                   out_name: str = None, out_names: Sequence[str] = None,
                   needs_key: bool = False, **kwargs):
        node_name = self._unique_name(label)
        if out_names is not None:
            if len(out_names) != n_outputs:
                raise ValueError(
                    f"out_names has {len(out_names)} entries for "
                    f"n_outputs={n_outputs}")
            bases = list(out_names)
        else:
            bases = [out_name if (out_name and n_outputs == 1) else
                     (f"{out_name}_{i}" if out_name else
                      (node_name if n_outputs == 1 else f"{node_name}:{i}"))
                     for i in range(n_outputs)]
        names = []
        outs = []
        for i, base in enumerate(bases):
            oname = self._unique_name(base) if base in self._vars else base
            if oname in self._vars:
                oname = self._unique_name(base)
            v = SDVariable(self, oname, VariableType.ARRAY)
            self._vars[oname] = v
            self._producer[oname] = (node_name, i)
            names.append(oname)
            outs.append(v)
        node = SameDiffOp(node_name, label, fn,
                          [v.name if v is not None else None for v in inputs],
                          names, kwargs, needs_key=needs_key)
        self._ops[node_name] = node
        self._op_order.append(node_name)
        if self._eager:
            self._try_eager(node)
        return outs[0] if n_outputs == 1 else tuple(outs)

    # -- generic op invocation (sd.op("conv2d", x, w, ...)) --------------
    def invoke(self, op_name: str, *inputs, n_outputs: int = 1, **kwargs):
        # None positional inputs pass through as literals (e.g. the
        # optional weights arg of loss ops)
        return self._record(op_name,
                            [self._as_var(i) if i is not None else None
                             for i in inputs],
                            n_outputs=n_outputs, **kwargs)

    # -- interpretation --------------------------------------------------
    def _trace(self, var_values: Dict[str, Any],
               placeholder_values: Dict[str, Any],
               requested: Sequence[str], rng_key=None,
               device=None) -> List[Any]:
        """Interpret the recorded graph on tensors: every op that
        ``requested`` needs, in recorded order (the reference's
        AbstractSession loop). ``rng_key`` (an int) seeds the keys of the
        random ops."""
        env: Dict[str, Any] = {}
        env.update(var_values)
        env.update(placeholder_values)
        needed = self._dependencies(requested, set(env))
        gen = (torch.Generator().manual_seed(int(rng_key))
               if rng_key is not None else None)
        device = self.device if device is None else device
        for op_name in self._op_order:
            if op_name not in needed:
                continue
            node = self._ops[op_name]
            args = [env[i] if i is not None else None for i in node.inputs]
            kwargs = dict(node.kwargs)
            if node.needs_key:
                kwargs["key"] = _rng.split(gen)
            result = run_node(node.fn, args, kwargs, device)
            self._bind_outputs(node, result, env)
        return [env[r] for r in requested]

    def _dependencies(self, requested: Sequence[str],
                      available: set) -> set:
        """Ops needed (transitively) to produce ``requested``."""
        needed_ops = set()
        stack = [r for r in requested if r not in available]
        seen_vars = set()
        while stack:
            var = stack.pop()
            if var in seen_vars:
                continue
            seen_vars.add(var)
            prod = self._producer.get(var)
            if prod is None:
                if var not in available and var not in self._arrays:
                    raise KeyError(
                        f"variable {var!r} has no value and no producer; "
                        f"missing placeholder?")
                continue
            op_name, _ = prod
            needed_ops.add(op_name)
            for i in self._ops[op_name].inputs:
                if i is not None and i not in available:
                    stack.append(i)
        return needed_ops

    def _graph_epoch(self):
        """Cache key component: changes whenever the graph mutates."""
        return (len(self._op_order), len(self._vars))

    def make_function(self, outputs: Sequence[str],
                      placeholders: Sequence[str],
                      with_rng: bool = False) -> Callable:
        """The graph as fn(var_dict, placeholder_dict[, key]) -> list of
        output tensors: placeholders moved to the graph's device, run
        under ``torch.no_grad()`` and ``full_f32()``, each new input
        signature counted by the dispatch census (tag ``sd:...``) and
        replayed as one CUDA graph (``captured_dispatch``; with a random
        op's ``key`` it runs eagerly)."""
        outputs = tuple(outputs)
        placeholders = tuple(placeholders)
        cache_key = (outputs, placeholders, with_rng, self._graph_epoch())
        fn = self._fn_cache.get(cache_key)
        if fn is None:
            from ..runtime.inference import captured_dispatch

            # a weak reference: the graph holds its functions, and a
            # cycle would keep a dropped graph's CUDA graphs until a
            # collection
            graph = weakref.ref(self)

            def raw(variables, ph, key=None):
                sd = graph()
                ph = {k: sd._tensor(v) for k, v in ph.items()}
                with torch.no_grad(), full_f32():
                    return sd._trace(variables, ph, outputs, key)

            fn = captured_dispatch(raw, f"sd:{id(self)}:{cache_key}",
                                   self.device)
            self._fn_cache[cache_key] = fn
        return fn

    def _release_graphs(self) -> None:
        """Let go of the captured forwards' graphs and the arrays they
        hold, once the arrays were replaced."""
        from ..runtime.inference import release_captured
        release_captured(self._fn_cache.values())

    def _rng_call_key(self) -> int:
        self._rng_calls = getattr(self, "_rng_calls", 0) + 1
        return self._rng_seed + self._rng_calls

    def output(self, placeholders: Dict[str, Any],
               outputs: Sequence[Union[str, SDVariable]]
               ) -> Dict[str, NDArray]:
        """Inference execution (reference SameDiff.output).

        Batch-bucketed for serving workloads (``runtime/inference.py``):
        placeholders sharing a leading batch dim are zero-padded up to the
        bucket and batch-shaped results sliced back, where
        ``_bucketable_padding`` proves that safe; graphs with random ops
        and everything else run at the exact shape."""
        out_names = [o.name if isinstance(o, SDVariable) else o
                     for o in outputs]
        ph = {k: self._tensor(v) for k, v in (placeholders or {}).items()}
        if any(node.needs_key for node in self._ops.values()):
            fn = self.make_function(out_names, tuple(sorted(ph)),
                                    with_rng=True)
            results = fn(self._arrays, ph, self._rng_call_key())
            return {n: NDArray(r) for n, r in zip(out_names, results)}
        fn = self.make_function(out_names, tuple(sorted(ph)))
        ph_p, pad = self._bucketable_padding(fn, ph, out_names)
        results = fn(self._arrays, ph_p)
        if pad is not None:
            from ..runtime.inference import slice_batch
            results = slice_batch(results, *pad)
        return {n: NDArray(r) for n, r in zip(out_names, results)}

    def _bucketable_padding(self, fn, ph, out_names):
        """(padded placeholders, (n, bucket)) when batch-dim bucketing is
        provably shape-safe for this graph, else (ph, None).

        Safe means: bucketing on, every placeholder shares the leading
        dim, and one run of the graph on ``meta`` tensors (shapes only, no
        data, no launch) at the exact and at the padded shape shows every
        requested output maps (n, *rest) -> (bucket, *rest). That rejects
        batch reductions, transposes and concatenations along the batch,
        host-read control flow (a ``cond`` predicate has no value on
        ``meta``) and any graph the padded shapes do not run through; a
        graph that couples rows but keeps the shape (``x - x.mean(0)``) is
        on the caller to exclude by turning bucketing off. The verdict is
        cached per placeholder signature."""
        from ..runtime.inference import maybe_pad_tree
        ph_p, pad = maybe_pad_tree(ph)
        if pad is None:
            return ph, None
        n, b = pad
        cache = getattr(fn, "_pad_gate", None)
        if cache is None:
            cache = fn._pad_gate = {}
        sig = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                           for k, v in ph.items()))
        ok = cache.get(sig)
        if ok is None:
            ok = self._pad_proof(ph, ph_p, out_names, n, b)
            cache[sig] = ok
        return (ph_p, pad) if ok else (ph, None)

    def _pad_proof(self, ph, ph_p, out_names, n, b) -> bool:
        meta = torch.device("meta")
        variables = {k: v.to(meta) for k, v in self._arrays.items()}
        try:
            with torch.no_grad():
                exact = self._trace(variables,
                                    {k: v.to(meta) for k, v in ph.items()},
                                    out_names, device=meta)
                padded = self._trace(variables,
                                     {k: v.to(meta) for k, v in ph_p.items()},
                                     out_names, device=meta)
        except Exception:
            return False
        return all(getattr(e, "ndim", 0) >= 1 and e.shape[0] == n
                   and tuple(p.shape) == (b,) + tuple(e.shape[1:])
                   for e, p in zip(exact, padded))

    def batch_output(self, placeholders=None, outputs=None):
        return self.output(placeholders or {}, outputs)

    # -- array access ----------------------------------------------------
    def get_arr_for_var(self, name: str) -> Optional[NDArray]:
        arr = self._arrays.get(name)
        if arr is None and self._eager:
            arr = self._eager_vals.get(name)
        return NDArray(arr) if arr is not None else None

    def set_array(self, name: str, value):
        self._arrays[name] = self._tensor(value)
        self._release_graphs()

    def get_variable(self, name: str) -> SDVariable:
        return self._vars[name]

    def has_variable(self, name: str) -> bool:
        return name in self._vars

    def variables(self) -> List[SDVariable]:
        return list(self._vars.values())

    def variable_names(self) -> List[str]:
        return list(self._vars)

    def trainable_variables(self) -> List[SDVariable]:
        return [v for v in self._vars.values()
                if v.var_type == VariableType.VARIABLE]

    def rename_variable(self, old: str, new: str):
        v = self._vars.pop(old)
        v.name = new
        self._vars[new] = v
        if old in self._arrays:
            self._arrays[new] = self._arrays.pop(old)
        if old in self._eager_vals:
            self._eager_vals[new] = self._eager_vals.pop(old)
        if old in self._producer:
            self._producer[new] = self._producer.pop(old)
        for node in self._ops.values():
            node.inputs = [new if i == old else i for i in node.inputs]
            node.outputs = [new if o == old else o for o in node.outputs]
        self._fn_cache.clear()

    # -- loss marking ----------------------------------------------------
    def set_loss_variables(self, *names):
        self._loss_variables = [n.name if isinstance(n, SDVariable) else n
                                for n in names]

    def loss_variables(self):
        return list(self._loss_variables)

    # -- gradients -------------------------------------------------------
    def calculate_gradients(self, placeholders: Dict[str, Any],
                            wrt: Sequence[Union[str, SDVariable]],
                            loss: Union[str, SDVariable] = None
                            ) -> Dict[str, NDArray]:
        """Analytic gradients of the (summed) loss with respect to the
        given variables: autograd through the interpreted forward, in
        place of the reference's gradient graph."""
        wrt_names = [w.name if isinstance(w, SDVariable) else w for w in wrt]
        loss_name = (loss.name if isinstance(loss, SDVariable) else loss) or \
            (self._loss_variables[0] if self._loss_variables else None)
        if loss_name is None:
            raise ValueError("no loss variable set")
        ph = {k: self._tensor(v) for k, v in (placeholders or {}).items()}
        with torch.enable_grad(), full_f32():
            leaves = {n: self._arrays[n].detach().requires_grad_(True)
                      for n in wrt_names}
            variables = dict(self._arrays)
            variables.update(leaves)
            out = self._trace(variables, ph, [loss_name])[0]
            grads = torch.autograd.grad(out.sum(), list(leaves.values()),
                                        allow_unused=True)
        return {n: NDArray(torch.zeros_like(leaves[n]) if g is None else g)
                for n, g in zip(wrt_names, grads)}

    # -- control flow (reference If/While/TensorArray; SubGraph bodies) --
    def cond(self, pred, true_fn, false_fn, *operands):
        """If-op with sub-graph branches (reference SameDiff.ifCond).

        Branch fns receive one SDVariable per operand (optionally preceded
        by the sub-SameDiff: ``lambda sd, x: ...``) and must return the
        same number of outputs. Differentiable through the branch
        taken."""
        from .subgraph import SubGraph
        tg, n_out_t = SubGraph.record(true_fn, len(operands), "t",
                                      self.device)
        fg, n_out_f = SubGraph.record(false_fn, len(operands), "f",
                                      self.device)
        if n_out_t != n_out_f:
            raise ValueError("cond branches must return the same number of "
                             f"outputs ({n_out_t} vs {n_out_f})")
        cap = self._captured_union(tg, fg)
        return self._record("cond",
                            [self._as_var(pred)] +
                            [self._as_var(o) for o in operands] +
                            [self._vars[n] for n in cap],
                            n_outputs=n_out_t, true_graph=tg, false_graph=fg,
                            n_base=len(operands), cap_names=cap)

    def while_loop(self, cond_fn, body_fn, *loop_vars):
        """While-op (reference SameDiff.whileLoop). Forward only, as the
        JAX package's; use ``scan`` for trainable loops."""
        from .subgraph import SubGraph
        cg, n_c = SubGraph.record(cond_fn, len(loop_vars), "c", self.device)
        if n_c != 1:
            raise ValueError("while_loop cond must return one boolean")
        bg, n_b = SubGraph.record(body_fn, len(loop_vars), "b", self.device)
        if n_b != len(loop_vars):
            raise ValueError(f"while_loop body must return {len(loop_vars)} "
                             f"values (got {n_b})")
        cap = self._captured_union(cg, bg)
        return self._record("while_loop",
                            [self._as_var(v) for v in loop_vars] +
                            [self._vars[n] for n in cap],
                            n_outputs=len(loop_vars),
                            cond_graph=cg, body_graph=bg,
                            n_loop_vars=len(loop_vars), cap_names=cap)

    def scan(self, body_fn, init, xs=None, length=None, reverse=False):
        """A scan as a graph op: the trainable loop (in place of the
        reference's While + TensorArray accumulation pattern).

        body_fn(*carry, *x_slices) -> (*new_carry, *ys). Returns
        (final_carry..., stacked_ys...) SDVariables."""
        from .subgraph import SubGraph
        init = list(init) if isinstance(init, (tuple, list)) else [init]
        xs = list(xs) if isinstance(xs, (tuple, list)) else \
            ([xs] if xs is not None else [])
        bg, n_out = SubGraph.record(body_fn, len(init) + len(xs), "s",
                                    self.device)
        n_ys = n_out - len(init)
        if n_ys < 0:
            raise ValueError("scan body must return at least the carry")
        cap = list(bg.captured)
        return self._record("scan",
                            [self._as_var(v) for v in init + xs] +
                            [self._vars[n] for n in cap],
                            n_outputs=n_out, body_graph=bg,
                            n_carry=len(init), n_scan=len(xs),
                            cap_names=cap, length=length, reverse=reverse)

    def _captured_union(self, *graphs):
        cap: List[str] = []
        for g in graphs:
            for n in g.captured:
                if n not in cap:
                    if n not in self._vars:
                        raise KeyError(
                            f"control-flow body captured unknown variable "
                            f"{n!r}")
                    cap.append(n)
        return cap

    def tensor_array(self, size: int, element_shape, dtype="float32"):
        """TensorArray analog (reference TensorArray ops): a functional
        fixed-size array backed by an SDVariable."""
        return TensorArray(self, size, element_shape, dtype)

    # -- namespaces (ops_namespaces.py) ----------------------------------
    @property
    def math(self):
        from .ops_namespaces import SDMath
        return SDMath(self)

    @property
    def nn(self):
        from .ops_namespaces import SDNN
        return SDNN(self)

    @property
    def cnn(self):
        from .ops_namespaces import SDCNN
        return SDCNN(self)

    @property
    def rnn(self):
        from .ops_namespaces import SDRNN
        return SDRNN(self)

    @property
    def loss(self):
        from .ops_namespaces import SDLoss
        return SDLoss(self)

    @property
    def image(self):
        from .ops_namespaces import SDImage
        return SDImage(self)

    @property
    def random(self):
        from .ops_namespaces import SDRandom
        return SDRandom(self)

    @property
    def linalg(self):
        from .ops_namespaces import SDLinalg
        return SDLinalg(self)

    @property
    def bitwise(self):
        from .ops_namespaces import SDBitwise
        return SDBitwise(self)

    # -- training (training.py) ------------------------------------------
    def fit(self, *args, **kwargs):
        from .training import fit as _fit
        return _fit(self, *args, **kwargs)

    def set_training_config(self, config):
        self.training_config = config

    def add_listener(self, listener):
        self._listeners.append(listener)

    # -- summary ---------------------------------------------------------
    def summary(self) -> str:
        lines = [f"SameDiff: {len(self._vars)} variables, "
                 f"{len(self._ops)} ops"]
        for v in self._vars.values():
            lines.append(f"  {v.var_type.value:<12} {v.name:<30} "
                         f"{v.shape} {v.dtype}")
        for name in self._op_order:
            node = self._ops[name]
            lines.append(f"  OP {node.op_name:<20} {node.inputs} -> "
                         f"{node.outputs}")
        return "\n".join(lines)

    # -- serialization (serialization.py) --------------------------------
    def save(self, path, save_updater_state: bool = False):
        from .serialization import save as _save
        _save(self, path, save_updater_state)

    @staticmethod
    def load(path, device="cuda") -> "SameDiff":
        from .serialization import load as _load
        return _load(path, device=device)

    def save_flatbuffers(self, path, save_updater_state: bool = False):
        """The reference FlatBuffers format (a FlatGraph ``.fb``), read
        back by ``modelimport.samediff_fb.load_samediff_fb``."""
        from .serialization import save_flatbuffers as _save_fb
        _save_fb(self, path, save_updater_state)
