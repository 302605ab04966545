"""The ComputationGraph (the layer API's DAG network) and its vertices."""
from .computation_graph import (ComputationGraph,  # noqa: F401
                                ComputationGraphConfiguration, GraphBuilder,
                                LayerVertex)
from .vertices import (AttentionVertex, ElementWiseVertex,  # noqa: F401
                       GraphVertex, L2NormalizeVertex, L2Vertex, MergeVertex,
                       PreprocessorVertex, ReshapeVertex, ScaleVertex,
                       ShiftVertex, StackVertex, SubsetVertex, UnstackVertex)
