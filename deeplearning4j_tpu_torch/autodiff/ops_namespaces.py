"""Fluent op namespaces: sd.math / sd.nn / sd.cnn / sd.rnn / sd.loss / ...

Counterpart of ``deeplearning4j_tpu/autodiff/ops_namespaces.py`` (the
reference's generated ``SDMath``, ``SDNN``, ``SDCNN``, ``SDRNN``,
``SDLoss``, ``SDImage``, ``SDRandom``, ``SDLinalg``, ``SDBitwise``): a
namespace method is any registered op name, or one of the aliases below.
"""
from __future__ import annotations

from typing import Sequence

from ..ops.registry import OpRegistry


class _Namespace:
    """Auto-generates methods for a set of registered op names."""

    OPS: Sequence[str] = ()
    ALIASES = {}  # method name -> op name

    def __init__(self, sd):
        self.sd = sd

    def __getattr__(self, item):
        op_name = self.ALIASES.get(item, item)
        if OpRegistry.get().has(op_name):
            def call(*inputs, **kwargs):
                n_outputs = kwargs.pop("n_outputs", 1)
                return self.sd.invoke(op_name, *inputs, n_outputs=n_outputs,
                                      **kwargs)
            call.__name__ = item
            return call
        raise AttributeError(f"{type(self).__name__} has no op {item!r}")

    def __dir__(self):
        reg = OpRegistry.get()
        return sorted(set(list(self.OPS) + list(self.ALIASES)
                          + [n for n in reg.names()]))


class SDMath(_Namespace):
    ALIASES = {
        "pow": "Pow", "floor": "Floor", "log1p": "Log1p",
        "mmul": "matmul", "sub": "subtract", "mul": "multiply",
        "div": "divide", "rsub": "reversesubtract", "rdiv": "reversedivide",
        "neq": "not_equals", "eq": "equals", "gt": "greater",
        "gte": "greater_equal", "lt": "less", "lte": "less_equal",
        "and_": "boolean_and", "or_": "boolean_or", "xor": "boolean_xor",
        "not_": "boolean_not",
    }


class SDNN(_Namespace):
    ALIASES = {
        "linear": "xw_plus_b",
        "bias_add": "biasadd",
        "leaky_relu": "lrelu",
        "multi_head_attention": "multi_head_dot_product_attention",
        "attention": "dot_product_attention",
    }


class SDCNN(_Namespace):
    ALIASES = {
        "conv3d": "conv3dnew",
        "max_pooling2d": "maxpool2d",
        "avg_pooling2d": "avgpool2d",
        "max_pooling3d": "maxpool3dnew",
        "avg_pooling3d": "avgpool3dnew",
        "separable_conv2d": "sconv2d",
        "local_response_normalization": "lrn",
    }


class SDRNN(_Namespace):
    ALIASES = {
        "lstm_layer": "lstmLayer",
        "lstm_cell": "lstmLayerCell",
        "gru_cell": "gruCell",
    }


class SDLoss(_Namespace):
    ALIASES = {
        "mean_squared_error": "mean_sqerr_loss",
        "absolute_difference": "absolute_difference_loss",
        "softmax_cross_entropy": "softmax_cross_entropy_loss",
        "sigmoid_cross_entropy": "sigm_cross_entropy_loss",
        "sparse_softmax_cross_entropy":
            "sparse_softmax_cross_entropy_loss_with_logits",
        "huber": "huber_loss", "hinge": "hinge_loss", "log": "log_loss",
        "cosine_distance": "cosine_distance_loss",
        "mean_pairwise_squared_error": "mean_pairwssqerr_loss",
        "ctc": "ctc_loss",
    }


class SDImage(_Namespace):
    pass


class SDRandom(_Namespace):
    ALIASES = {
        "uniform": "randomuniform", "normal": "random_normal",
        "bernoulli": "random_bernoulli", "exponential": "random_exponential",
    }


class SDLinalg(_Namespace):
    ALIASES = {"inverse": "matrix_inverse", "det": "matrix_determinant"}


class SDBitwise(_Namespace):
    ALIASES = {
        "and_": "bitwise_and", "or_": "bitwise_or", "xor": "bitwise_xor",
        "left_shift": "shift_bits", "right_shift": "rshift_bits",
    }
