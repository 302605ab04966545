"""Op validation framework: declarative per-op TestCases.

Counterpart of ``deeplearning4j_tpu/autodiff/validation.py`` (the
reference's ``OpValidation.validate(TestCase)``): (a) forward against an
expected value, (b) analytic against numeric gradients (central
difference), (c) a serialization round trip through the SameDiff zip
format, and (d) per-op coverage accounting. A test case runs on the
card unless given ``device="cpu"``.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..nn.multilayer import resolve_device
from ..ops import OpRegistry
from .samediff import to_tensor


def _np(x) -> np.ndarray:
    t = x.detach().cpu() if isinstance(x, torch.Tensor) else x
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        t = t.float()
    return np.asarray(t)


class TestCase:
    """Declarative op test (reference validation/TestCase.java)."""

    __test__ = False  # not a pytest class

    def __init__(self, op_name: str, inputs: Sequence[Any] = (),
                 kwargs: Optional[Dict] = None, device="cuda"):
        self.op_name = op_name
        self.device = resolve_device(device)
        self.inputs = [to_tensor(i, self.device) for i in inputs]
        self.kwargs = kwargs or {}
        self.expected: Optional[Any] = None
        self.expected_fn: Optional[Callable] = None
        self.gradient_check = False
        self.serialization_check = True
        self.tolerance = 1e-5
        self.grad_tolerance = 1e-3

    def expect(self, value) -> "TestCase":
        self.expected = value
        return self

    def expect_fn(self, fn: Callable) -> "TestCase":
        """Expected output computed from a reference (numpy) function."""
        self.expected_fn = fn
        return self

    def grad_check(self, enabled: bool = True) -> "TestCase":
        self.gradient_check = enabled
        return self

    def no_serialization(self) -> "TestCase":
        self.serialization_check = False
        return self

    def tol(self, t: float) -> "TestCase":
        self.tolerance = t
        return self


class OpValidation:
    """validate(TestCase) and coverage accounting."""

    _validated: set = set()
    _lock = threading.Lock()

    @staticmethod
    def validate(tc: TestCase) -> Optional[str]:
        """Runs all enabled checks; returns None on success, else the
        failure description (the reference returns an error string
        too)."""
        reg = OpRegistry.get()
        opdef = reg.lookup(tc.op_name)
        errors: List[str] = []

        with torch.no_grad():
            out = opdef.fn(*tc.inputs, **tc.kwargs)

        # (a) forward vs expected
        expected = tc.expected
        if expected is None and tc.expected_fn is not None:
            expected = tc.expected_fn(*[_np(i) for i in tc.inputs])
        if expected is not None:
            got = out[0] if isinstance(out, (tuple, list)) and \
                not isinstance(expected, (tuple, list)) else out
            try:
                if isinstance(expected, (tuple, list)):
                    for g, e in zip(got, expected):
                        np.testing.assert_allclose(_np(g), np.asarray(e),
                                                   atol=tc.tolerance,
                                                   rtol=tc.tolerance)
                else:
                    np.testing.assert_allclose(_np(got), np.asarray(expected),
                                               atol=tc.tolerance,
                                               rtol=tc.tolerance)
            except AssertionError as e:
                errors.append(f"forward mismatch: {e}")

        # (b) analytic vs numeric gradient (central difference)
        if tc.gradient_check and opdef.differentiable:
            err = OpValidation._grad_check(opdef.fn, tc)
            if err:
                errors.append(err)

        # (c) serialization round-trip through the SameDiff zip format
        if tc.serialization_check:
            err = OpValidation._serialization_check(tc, out)
            if err:
                errors.append(err)

        if not errors:
            with OpValidation._lock:
                OpValidation._validated.add(opdef.name)
            return None
        return f"{tc.op_name}: " + "; ".join(errors)

    @staticmethod
    def _grad_check(fn, tc: TestCase, eps: float = 1e-2) -> Optional[str]:
        # eps balances f32 round-off against truncation: 1e-2 keeps the
        # central difference's signal above f32 summation noise
        diff_idx = [i for i, x in enumerate(tc.inputs)
                    if x.is_floating_point()]
        if not diff_idx:
            return None

        def scalar_fn(*diff_inputs):
            full = list(tc.inputs)
            for i, v in zip(diff_idx, diff_inputs):
                full[i] = v
            out = fn(*full, **tc.kwargs)
            if isinstance(out, (tuple, list)):
                out = out[0]
            return torch.sum(out.to(torch.float64)
                             if out.is_floating_point() else out)

        diff_inputs = [tc.inputs[i].to(torch.float32) for i in diff_idx]
        with torch.enable_grad():
            leaves = [x.clone().requires_grad_(True) for x in diff_inputs]
            analytic = torch.autograd.grad(scalar_fn(*leaves), leaves,
                                           allow_unused=True)
        with torch.no_grad():
            for k, (x, g) in enumerate(zip(diff_inputs, analytic)):
                flat = x.cpu().numpy().astype(np.float64).ravel()
                g_flat = (np.zeros_like(flat) if g is None
                          else g.cpu().numpy().astype(np.float64).ravel())
                # probe a bounded sample of coordinates (reference
                # subsampling)
                idxs = range(len(flat)) if len(flat) <= 32 else \
                    np.linspace(0, len(flat) - 1, 32).astype(int)
                for j in idxs:
                    xp = flat.copy()
                    xm = flat.copy()
                    xp[j] += eps
                    xm[j] -= eps
                    args_p = list(diff_inputs)
                    args_m = list(diff_inputs)
                    args_p[k] = torch.as_tensor(xp.reshape(x.shape),
                                                dtype=torch.float32,
                                                device=x.device)
                    args_m[k] = torch.as_tensor(xm.reshape(x.shape),
                                                dtype=torch.float32,
                                                device=x.device)
                    numeric = (float(scalar_fn(*args_p)) -
                               float(scalar_fn(*args_m))) / (2 * eps)
                    if abs(numeric - g_flat[j]) > tc.grad_tolerance * \
                            max(1.0, abs(numeric), abs(g_flat[j])):
                        return (f"gradient mismatch input {k} elem {j}: "
                                f"analytic={g_flat[j]:.6g} "
                                f"numeric={numeric:.6g}")
        return None

    @staticmethod
    def _serialization_check(tc: TestCase, eager_out) -> Optional[str]:
        import os
        import tempfile
        from .samediff import SameDiff

        sd = SameDiff.create(device=tc.device)
        vars_ = [sd.constant(x, f"in{i}") for i, x in enumerate(tc.inputs)]
        try:
            out_var = sd._record(tc.op_name, vars_, **tc.kwargs)
        except Exception as e:
            return f"graph-record failed: {type(e).__name__}: {e}"
        out_var.rename("out")
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "op.sdz")
            try:
                sd.save(path)
                sd2 = SameDiff.load(path, device=tc.device)
                r2 = sd2.output({}, ["out"])["out"].numpy()
            except Exception as e:
                return f"serialization round-trip failed: " \
                       f"{type(e).__name__}: {e}"
        ref = eager_out[0] if isinstance(eager_out, (tuple, list)) \
            else eager_out
        try:
            np.testing.assert_allclose(r2, _np(ref), atol=tc.tolerance,
                                       rtol=tc.tolerance)
        except AssertionError as e:
            return f"post-serialization output mismatch: {e}"
        return None

    # -- coverage accounting ---------------------------------------------
    @staticmethod
    def validated_ops() -> List[str]:
        with OpValidation._lock:
            return sorted(OpValidation._validated)

    @staticmethod
    def coverage_report() -> Dict[str, Any]:
        reg = OpRegistry.get()
        all_ops = set(reg.names())
        validated = set(OpValidation.validated_ops())
        return {
            "validated": len(validated & all_ops),
            "total": len(all_ops),
            "unvalidated": sorted(all_ops - validated),
        }
