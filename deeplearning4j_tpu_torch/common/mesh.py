"""The two reporting helpers of the JAX package's ``common/mesh.py`` that
the serving registry reads (``/v1/models``'s ``mesh_shape`` and
``param_spec``).

The port has no device mesh yet: tensor-parallel deploys wait for the
parallelism slice (``ROADMAP.md`` queue 1 item 10), and
``ModelRegistry.deploy(mesh=...)`` refuses before it gets here. Both
helpers give what the JAX package gives for ``None`` and refuse
anything else.
"""
from __future__ import annotations

from typing import Dict, Optional

#: the model-parallel axis name, as in the JAX package
MODEL = "model"

_NOT_PORTED = ("sharded deploys (mesh=/param_spec=) are not ported yet "
               "(ROADMAP.md queue 1 item 10, parallelism)")


def mesh_shape(mesh) -> Optional[Dict[str, int]]:
    """``{"data": d, "model": m}`` for a mesh; None for None."""
    if mesh is None:
        return None
    raise NotImplementedError(_NOT_PORTED)


def spec_desc(spec) -> str:
    """Stable description of a ``param_spec`` deploy argument:
    ``"auto(model)"`` for None."""
    if spec is None:
        return f"auto({MODEL})"
    raise NotImplementedError(_NOT_PORTED)
