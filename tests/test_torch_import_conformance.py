"""The port's TF and ONNX mappers against the JAX package's, case for case.

The cases are the JAX package's own: ``tests/test_tf_mapper_conformance.py``,
``tests/test_onnx_mapper_conformance.py`` and the while/cond frame, ONNX
LSTM/GRU, convolution and residual-block cases of
``tests/test_modelimport.py``. Each of those files is loaded a second
time under a private name, and its graph runner (``run_case``, ``run1``)
or importer (``import_tf_graph``, ``import_onnx_model``) is replaced by
one that imports the same bytes with both packages
(``torch_import_check.py``). The JAX side runs once per case; the port
(on the CPU) must agree with it on every output and on every static
shape the JAX import propagated, and the case's own checks then run on
the port's outputs.

Tolerances: a TF case holds the port to the JAX package at the case's own
golden tolerance (1e-5 unless the case names one) or by its own check
(sign-free SVD factors, NMS padding); the ONNX and ``test_modelimport``
cases at ``PORT_VS_JAX`` (atol 1e-5, rtol 1e-5), and then at their own
numpy or torch goldens. Graphs with random ops agree in shape and dtype
only; their cases check the port's draws' ranges and moments.
"""
import functools
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
tf1 = tf.compat.v1

from deeplearning4j_tpu_torch.modelimport import \
    import_tf_graph as port_import_tf  # noqa: E402

from torch_import_check import both_onnx, both_tf  # noqa: E402

TESTS = Path(__file__).resolve().parent


def _load(name: str):
    """A second, private copy of a test module of the JAX package."""
    spec = importlib.util.spec_from_file_location(
        f"_port_{name}", TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cases(mod, only=None):
    out = []
    for cname, cls in vars(mod).items():
        if not (isinstance(cls, type) and cname.startswith("Test")):
            continue
        for mname in sorted(vars(cls)):
            if mname.startswith("test_") and \
                    (only is None or f"{cname}::{mname}" in only):
                out.append(f"{cname}::{mname}")
    return out


def _call(mod, case):
    cname, mname = case.split("::")
    method = getattr(getattr(mod, cname)(), mname)
    if "_v1_control_flow" in inspect.signature(method).parameters:
        tf1.disable_control_flow_v2()
        try:
            method(None)
        finally:
            tf1.enable_control_flow_v2()
    else:
        method()


# ------------------------------------------------------------------ TF
TFC = _load("test_tf_mapper_conformance")


def _tf_run_case(build, inputs, atol=1e-5, rtol=1e-5, n_outputs=1,
                 input_dtypes=None, check=None):
    """``run_case`` of the JAX file, importing with both packages."""
    g = tf.Graph()
    with g.as_default():
        phs = []
        for i, arr in enumerate(inputs):
            dt = (input_dtypes[i] if input_dtypes
                  else tf.as_dtype(arr.dtype))
            phs.append(tf1.placeholder(dt, arr.shape, name=f"x{i}"))
        out = build(*phs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        outs = [tf.identity(o, name=f"out{i}") for i, o in enumerate(outs)]
    pb = g.as_graph_def().SerializeToString()
    names = [f"out{i}" for i in range(len(outs))]
    imp = both_tf(pb, tol=dict(atol=atol, rtol=rtol), check=check,
                  input_shapes={f"x{i}": a.shape
                                for i, a in enumerate(inputs)},
                  outputs=names)
    imp.output({f"x{i}": a for i, a in enumerate(inputs)}, names)


TFC.run_case = _tf_run_case
# the random-op cases import directly: they check the port's draws
TFC.import_tf_graph = functools.partial(port_import_tf, device="cpu")


@pytest.mark.parametrize("case", _cases(TFC))
def test_tf_mapper_case(case):
    _call(TFC, case)


# ---------------------------------------------------------------- ONNX
ONNXC = _load("test_onnx_mapper_conformance")


def _onnx_run1(node, feeds, initializers=None, out_shape=(1,), n_outputs=1):
    """``run1`` of the JAX file, importing with both packages; returns
    the port's outputs to the case's numpy goldens."""
    inputs = [(k, v.shape, ONNXC._DT[np.asarray(v).dtype])
              for k, v in feeds.items()]
    outs = [(f"y{i}" if n_outputs > 1 else "y", out_shape)
            for i in range(n_outputs)]
    data = ONNXC.build_model([node], initializers or {}, inputs, outs)
    names = [o[0] for o in outs]
    res = both_onnx(data).output(dict(feeds), names)
    arrs = [res[n].numpy() for n in names]
    return arrs[0] if n_outputs == 1 else arrs


ONNXC.run1 = _onnx_run1


@pytest.mark.parametrize("case", _cases(ONNXC))
def test_onnx_mapper_case(case):
    _call(ONNXC, case)


# ------------------------------------- test_modelimport.py's graph cases
MI = _load("test_modelimport")
MI.import_tf_graph = both_tf
MI.import_onnx_model = both_onnx
GRAPH_CASES = {
    "TestTFImport::test_mlp_golden",
    "TestTFImport::test_shape_chain_constant_folding",
    "TestTFImport::test_conv_pool_golden",
    "TestTFImport::test_strided_slice_masks",
    "TestBertImport::test_bert_golden",
    "TestOnnxImport::test_mlp",
    "TestOnnxImport::test_gemm_and_reduce",
    "TestTF1WhileImport::test_synthetic_while_with_placeholder",
    "TestTF1WhileImport::test_two_sequential_while_loops",
    "TestTF1WhileImportEdgeCases::test_nested_while_loops",
    "TestTF1WhileImportEdgeCases::test_loop_invariant_body_output",
    "TestTF1WhileImportEdgeCases::test_lstm_initial_state_and_unsupported",
    "TestTF1CondImport::test_cond_both_branches",
    "TestTF1CondImport::test_cond_constant_branch",
    "TestTF1CondImport::test_nested_cond",
    "TestOnnxLSTM::test_lstm_matches_numpy",
    "TestOnnxGRU::test_gru_lbr0_matches_numpy",
    "TestOnnxGRU::test_gru_lbr1_matches_torch",
    "TestOnnxResNetBlock::test_residual_block_matches_torch",
    "TestOnnxGroupedConv::test_grouped_conv_matches_torch",
}


@pytest.mark.parametrize("case", _cases(MI, GRAPH_CASES))
def test_graph_case(case):
    _call(MI, case)


def test_every_graph_case_is_collected():
    assert set(_cases(MI, GRAPH_CASES)) == GRAPH_CASES
