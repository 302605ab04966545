from .ndarray import NDArray  # noqa: F401
from . import factory  # noqa: F401
