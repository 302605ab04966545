from .config import (InputType, MultiLayerConfiguration,  # noqa: F401
                     NeuralNetConfiguration)
from .constraints import (MaxNormConstraint, MinMaxNormConstraint,  # noqa: F401
                          NonNegativeConstraint, UnitNormConstraint)
from .weightnoise import DropConnect, WeightNoise  # noqa: F401
