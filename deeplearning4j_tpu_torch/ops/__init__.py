"""Op library: named, registered functions over tensors.

Counterpart of ``deeplearning4j_tpu/ops/__init__.py``: importing this
package registers every op family under the JAX package's names (the
reference's ``DECLARE_OP`` auto-registration), then derives the ``_bp``
ops (``autobp.py``).
"""
from .registry import OpRegistry, exec_op, op  # noqa: F401

from . import (  # noqa: F401  (import for registration side effects)
    bitwise_ops,
    compression,
    controlflow,
    conv_ops,
    image_ops,
    linalg_ops,
    list_ops,
    loss_ops,
    nlp_ops,
    nn_ops,
    pairwise,
    parity_extra,
    random_ops,
    recurrent,
    reduce,
    segment_ops,
    shape_ops,
    string_ops,
    transforms,
    updater_ops,
)
from . import autobp  # noqa: F401,E402  (last: derives _bp ops from the above)


def registry() -> OpRegistry:
    return OpRegistry.get()
