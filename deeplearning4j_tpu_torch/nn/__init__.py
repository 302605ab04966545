"""Layer-based NN API (the DL4J layer API): the configuration DSL,
``MultiLayerNetwork``, the ``ComputationGraph`` and its vertices,
evaluation and listeners, and the training utilities (``serde``,
``checkpoint``, ``earlystopping``, ``transferlearning``, ``solvers``),
with every layer class of the JAX package's ``nn/conf/``."""
from .conf.config import (InputType, MultiLayerConfiguration,  # noqa: F401
                          NeuralNetConfiguration)
from .conf import layers  # noqa: F401
from .evaluation import Evaluation, RegressionEvaluation, ROC  # noqa: F401
from .graph import (ComputationGraph,  # noqa: F401
                    ComputationGraphConfiguration, GraphBuilder)
from .multilayer import MultiLayerNetwork  # noqa: F401
