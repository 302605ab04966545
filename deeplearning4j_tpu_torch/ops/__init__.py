"""Op library: named, registered functions over tensors.

Counterpart of ``deeplearning4j_tpu/ops/__init__.py``: importing this
package registers every ported op family under the JAX package's names
(the reference's ``DECLARE_OP`` auto-registration), lists the families
still to be ported as pending (``pending.py``), and derives the ``_bp``
ops last (``autobp.py``).
"""
from .registry import OpRegistry, exec_op, op  # noqa: F401

from . import (  # noqa: F401  (import for registration side effects)
    controlflow,
    conv_ops,
    image_ops,
    linalg_ops,
    loss_ops,
    nlp_ops,
    nn_ops,
    pairwise,
    random_ops,
    recurrent,
    reduce,
    shape_ops,
    transforms,
    updater_ops,
)
from .pending import register_pending

register_pending(OpRegistry.get())

from . import autobp  # noqa: F401,E402  (last: derives _bp ops from the above)


def registry() -> OpRegistry:
    return OpRegistry.get()
