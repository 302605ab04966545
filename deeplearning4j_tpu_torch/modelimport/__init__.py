"""Model import: foreign-framework graphs -> SameDiff.

Counterpart of ``deeplearning4j_tpu/modelimport/`` (the reference's
``nd4j/samediff-import/`` Kotlin IR and mapping rules, ``ImportGraph.kt``).
Every foreign node maps onto a registered op (``ops/``), so an imported
graph *is* a SameDiff graph, built on the caller's device (``device=``,
the card by default) and run with ``output()``. Parsing uses the
self-contained protobuf decoder (``protoio.py``) and FlatBuffers reader
(``flatbuf.py``): no tensorflow, onnx, flatbuffers or ml_dtypes package.

Ported: the IR, the TF GraphDef and ONNX importers, the SameDiff
FlatBuffers graph (``samediff_fb.py``) and the Keras h5 importer
(``keras/``), which reads h5 files with the port's own HDF5 reader
(``h5.py``): no h5py either.
"""
from .ir import IRGraph, IRNode, ImportContext, ImportException
from .keras.importer import (KerasModelImport, import_keras_model_and_weights,
                             import_keras_sequential_model_and_weights)
from .onnx.importer import OnnxImporter, import_onnx_model
from .tf.importer import TFGraphImporter, import_tf_graph

__all__ = [
    "IRGraph", "IRNode", "ImportContext", "ImportException",
    "TFGraphImporter", "import_tf_graph",
    "OnnxImporter", "import_onnx_model",
    "KerasModelImport", "import_keras_model_and_weights",
    "import_keras_sequential_model_and_weights",
]
