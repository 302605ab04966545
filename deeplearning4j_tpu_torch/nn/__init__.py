"""Layer-based NN API (the DL4J layer API): the configuration DSL,
``MultiLayerNetwork``, evaluation and listeners. The ComputationGraph
waits for ``ROADMAP.md`` queue 1 item 9."""
from .conf.config import (InputType, MultiLayerConfiguration,  # noqa: F401
                          NeuralNetConfiguration)
from .conf import layers  # noqa: F401
from .evaluation import Evaluation, RegressionEvaluation, ROC  # noqa: F401
from .multilayer import MultiLayerNetwork  # noqa: F401
