"""Model import: foreign-framework graphs -> SameDiff.

Counterpart of ``deeplearning4j_tpu/modelimport/`` (the reference's
``nd4j/samediff-import/`` Kotlin IR and mapping rules, ``ImportGraph.kt``).
Every foreign node maps onto a registered op (``ops/``), so an imported
graph *is* a SameDiff graph, built on the caller's device (``device=``,
the card by default) and run with ``output()``. Parsing uses the
self-contained protobuf decoder (``protoio.py``) and FlatBuffers reader
(``flatbuf.py``): no tensorflow, onnx, flatbuffers or ml_dtypes package.

Ported: the IR, the TF GraphDef and ONNX importers and the SameDiff
FlatBuffers graph (``samediff_fb.py``). The Keras importer is not ported
yet (``ROADMAP.md`` queue 1 item 11c-ii); its entry points raise.
"""
from .ir import IRGraph, IRNode, ImportContext, ImportException
from .onnx.importer import OnnxImporter, import_onnx_model
from .tf.importer import TFGraphImporter, import_tf_graph


def _keras_not_ported(*args, **kwargs):
    raise NotImplementedError(
        "the Keras importer is not ported yet; it waits for ROADMAP.md "
        "queue 1 item 11c-ii")


class KerasModelImport:
    """The Keras h5 importer: not ported yet (item 11c-ii)."""

    import_keras_model_and_weights = staticmethod(_keras_not_ported)
    import_keras_sequential_model_and_weights = staticmethod(
        _keras_not_ported)


import_keras_model_and_weights = _keras_not_ported
import_keras_sequential_model_and_weights = _keras_not_ported

__all__ = [
    "IRGraph", "IRNode", "ImportContext", "ImportException",
    "TFGraphImporter", "import_tf_graph",
    "OnnxImporter", "import_onnx_model",
    "KerasModelImport", "import_keras_model_and_weights",
    "import_keras_sequential_model_and_weights",
]
