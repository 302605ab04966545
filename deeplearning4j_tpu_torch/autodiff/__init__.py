"""Define-then-run autodiff graph layer (the SameDiff analog): the
counterpart of ``deeplearning4j_tpu/autodiff``."""
from .samediff import SameDiff, SDVariable, VariableType  # noqa: F401
from .training import TrainingConfig, History  # noqa: F401
