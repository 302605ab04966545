"""The port's op descriptors (``deeplearning4j_tpu_torch/ops/descriptors.py``)
against the JAX package's: every registered name has one, the JSON
export round-trips, and each op's keyword arguments (the arguments with
a default: names and defaults) equal the JAX op's, but for the artefacts
of the library function each registry wraps, listed below by kind and
each checked in its normalised form. The mirror of
``tests/test_descriptors_profiler.py::TestOpDescriptors``.
"""
import json
import re

import pytest

import deeplearning4j_tpu.ops  # noqa: F401  (registers the JAX ops)
from deeplearning4j_tpu.ops import descriptors as jdesc

import deeplearning4j_tpu_torch.ops as tops
from deeplearning4j_tpu_torch.ops.descriptors import (all_descriptors,
                                                      describe, to_json)

#: numpy ufuncs (``jnp.add`` and kin) take ``out=`` and ``where=``, which
#: jax rejects unless None; the port's binary ops take the two operands
UFUNC = {"add", "subtract", "multiply", "maximum", "minimum", "neg",
         "bitwise_and", "bitwise_or", "bitwise_xor", "boolean_and",
         "boolean_or", "boolean_xor"}
#: a dtype default spelled ``jnp.float32`` there and ``"float32"`` or
#: ``torch.float32`` here
DTYPE = {"create", "decode_bitmap", "decode_threshold", "eye", "onehot",
         "random_bernoulli", "random_exponential", "random_gamma",
         "random_multinomial", "random_normal", "random_poisson",
         "randomuniform", "sequence_mask", "tri"}
#: the ``activation`` default: jax's jitted ``jnp.tanh`` there,
#: ``torch.tanh`` here
ACTIVATION = {"static_rnn", "static_bidirectional_rnn"}
#: torch builtins, whose signatures cannot be read, where the jax
#: function takes keywords of its own: ``jnp.round``'s ``decimals`` and
#: ``out`` (``torch.round`` takes ``decimals`` too), ``lax.rsqrt``'s
#: ``accuracy`` and the array-creation keywords of ``jnp.ones_like`` /
#: ``zeros_like``
BUILTIN = {"round": ["decimals", "out"], "rsqrt": ["accuracy"],
           "ones_as": ["dtype", "shape", "device", "out_sharding"],
           "zeros_as": ["dtype", "shape", "device", "out_sharding"]}
#: ``jax.scipy.special.zeta``'s ``q`` defaults to None and raises
#: without it; the port's ``q`` is required
REQUIRED_Q = {"zeta"}


def _keywords(desc):
    return [(a.name, a.default) for a in desc.args
            if not a.required and a.arg_type != "INPUT_TENSOR_ARRAY"]


def _dtype_name(default):
    return re.sub(r"^(<class 'jax\.numpy\.(\w+)'>|'(\w+)'|torch\.(\w+))$",
                  lambda m: m.group(2) or m.group(3) or m.group(4), default)


def _normalised(name, jkw, tkw):
    if name in UFUNC:
        return [kw for kw in jkw if kw[0] not in ("out", "where")], tkw
    if name in DTYPE:
        return ([(k, _dtype_name(v)) for k, v in jkw],
                [(k, _dtype_name(v)) for k, v in tkw])
    if name in ACTIVATION:
        tanh = lambda kws: [(k, "tanh" if k == "activation" and "tanh" in v  # noqa: E731,E501
                             else v) for k, v in kws]
        return tanh(jkw), tanh(tkw)
    if name in BUILTIN:
        return [k for k, _ in jkw], BUILTIN[name] if tkw == [] else tkw
    if name in REQUIRED_Q:
        return [kw for kw in jkw if kw != ("q", "None")], tkw
    return jkw, tkw


def test_keyword_arguments_match_the_jax_ops():
    allowed = UFUNC | DTYPE | ACTIVATION | set(BUILTIN) | REQUIRED_Q
    differ, still_differ = set(), []
    for name in tops.registry().names():
        jkw, tkw = _keywords(jdesc.describe(name)), _keywords(describe(name))
        if jkw != tkw:
            differ.add(name)
        j, t = _normalised(name, jkw, tkw)
        if j != t:
            still_differ.append((name, jkw, tkw))
    assert not still_differ, still_differ
    # the allow-list is exactly the ops whose keywords differ raw
    assert differ == allowed, (sorted(differ - allowed),
                               sorted(allowed - differ))


@pytest.mark.parametrize("name", ["gelu", "cross", "selu", "hardsigmoid",
                                  "swish", "mish", "hardswish", "cholesky",
                                  "self_adjoint_eig", "lstsq"])
def test_repaired_and_linalg_signatures_are_the_jax_ones(name):
    j, t = jdesc.describe(name), describe(name)
    assert [(a.name, a.required, a.default, a.arg_type) for a in t.args] == \
        [(a.name, a.required, a.default, a.arg_type) for a in j.args]


def test_every_registered_name_has_a_descriptor():
    reg = tops.registry()
    descs = all_descriptors()
    assert sorted(descs) == list(reg.names())
    for alias in ("solve_ls", "unsorted_segment_sum", "mmul"):
        d = describe(alias)
        assert alias in d.aliases and d.name in descs
    for name, d in descs.items():
        j = jdesc.describe(name)
        assert (d.name, d.category, d.differentiable, d.aliases) == \
            (j.name, j.category, j.differentiable, j.aliases)


def test_to_json_round_trips(tmp_path):
    path = tmp_path / "ops.json"
    text = to_json(str(path))
    data = json.loads(path.read_text())
    assert json.loads(text) == data
    assert sorted(data) == list(tops.registry().names())
    assert data["segment_sum"]["aliases"] == ["unsorted_segment_sum"]
    assert data["add"]["category"] == "pairwise"
    assert json.dumps(data, indent=1, sort_keys=True) == text


class TestOpDescriptors:
    def test_describe_matmul(self):
        d = describe("matmul")
        assert d.name == "matmul" and d.category == "blas"
        names = [a.name for a in d.args]
        assert names[:2] == ["a", "b"]
        ta = next(a for a in d.args if a.name == "transpose_a")
        assert ta.arg_type == "BOOL" and not ta.required

    def test_all_descriptors_cover_registry(self):
        descs = all_descriptors()
        assert len(descs) > 500
        assert "conv2d" in descs and "scan" in descs

    def test_json_export(self, tmp_path):
        path = str(tmp_path / "ops.json")
        to_json(path)
        data = json.loads(open(path).read())
        assert data["add"]["category"] == "broadcastable" or \
            "category" in data["add"]
