"""Holding the port's model import against the JAX package's on the same
bytes: both importers run, and each output and each static shape is
compared (shared by ``test_torch_modelimport.py`` and
``test_torch_import_conformance.py``; the port runs on the CPU).
"""
from __future__ import annotations

import functools

import numpy as np

from deeplearning4j_tpu.modelimport import (import_onnx_model as j_onnx,
                                            import_tf_graph as j_tf)
from deeplearning4j_tpu.modelimport.ir import ImportException as JImportExc
from deeplearning4j_tpu_torch.modelimport import (import_onnx_model as t_onnx,
                                                  import_tf_graph as t_tf)
from deeplearning4j_tpu_torch.modelimport.ir import \
    ImportException as TImportExc

#: port against JAX where a case names no tolerance: the same f32 ops in
#: another library (reduction orders, libm), well under the goldens' 1e-5
PORT_VS_JAX = dict(atol=1e-5, rtol=1e-5)


def check_avals(jctx, tctx):
    """Every SameDiff variable with a JAX static shape after import has
    one in the port, with the same shape and dtype."""
    missing, differ = [], []
    for name, ja in jctx._var_aval.items():
        ta = tctx._var_aval.get(name)
        if ta is None:
            missing.append(name)
        elif (tuple(ta.shape) != tuple(ja.shape)
              or ta.dtype != _np_dtype(ja.dtype)):
            differ.append((name, ja, ta))
    assert not missing and not differ, (missing, differ)
    return len(jctx._var_aval)


def _np_dtype(d):
    d = np.dtype(d)
    return np.dtype("V2") if d.name == "bfloat16" else d


def random_graph(imported) -> bool:
    return any(n.needs_key for n in imported.sd._ops.values())


class Both:
    """The JAX and the port import of one graph. ``output`` runs both,
    holds the port to the JAX package (values within ``tol``, or by
    ``check(i, port, jax)``; a graph with random ops by shape and dtype
    only) and the static shapes, and returns the port's results."""

    def __init__(self, jimp, timp, tol=None, check=None):
        self.jax, self.port = jimp, timp
        self.tol = dict(PORT_VS_JAX if tol is None else tol)
        self.check = check
        self.sd, self.ctx = timp.sd, timp.ctx

    def output(self, feeds, outputs=None):
        jr = self.jax.output(feeds, outputs)
        tr = self.port.output(feeds, outputs)
        assert list(jr) == list(tr)
        check_avals(self.jax.ctx, self.port.ctx)
        for i, k in enumerate(jr):
            j = np.asarray(jr[k].numpy())
            t = tr[k].numpy()
            assert t.shape == j.shape and t.dtype == j.dtype, \
                (k, t.shape, t.dtype, j.shape, j.dtype)
            if random_graph(self.port):
                continue
            if self.check is not None:
                self.check(i, t, j)
            else:
                np.testing.assert_allclose(t, j, err_msg=k, **self.tol)
        return tr


def both(jax_fn, port_fn, *args, tol=None, check=None, **kwargs) -> Both:
    """Import with both packages. An import that raises must raise on
    both sides; the JAX package's exception is raised again, so a test's
    ``pytest.raises`` (and its ``match``) sees the JAX package's."""
    results = []
    for fn, kw in ((port_fn, dict(kwargs, device="cpu")), (jax_fn, kwargs)):
        try:
            results.append(fn(*args, **kw))
        except (JImportExc, TImportExc) as e:
            results.append(e)
    timp, jimp = results
    if isinstance(timp, Exception) or isinstance(jimp, Exception):
        assert type(timp).__name__ == type(jimp).__name__, (timp, jimp)
        raise jimp
    return Both(jimp, timp, tol, check)


both_tf = functools.partial(both, j_tf, t_tf)
both_onnx = functools.partial(both, j_onnx, t_onnx)
