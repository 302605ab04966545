"""Foreign-runtime interop: run TF graphs, ONNX and TFLite models on NDArrays.

Counterpart of ``deeplearning4j_tpu/interop/`` (the reference's
``nd4j-tensorflow`` ``GraphRunner``, ``nd4j-onnxruntime``, ``nd4j-tvm``):
- `GraphRunner`: executes a frozen TF GraphDef through the tensorflow
  runtime when installed, else through the port's own TF importer on
  ``device`` (the card by default);
- `OnnxRunner`: executes ONNX models through the port's importer;
- `TfliteRunner`: executes float .tflite files directly (the port's own
  FlatBuffers reader, one CUDA graph per input signature on the card; no
  TFLite runtime needed).
"""
from .graph_runner import GraphRunner, OnnxRunner
from .tflite import TfliteRunner

__all__ = ["GraphRunner", "OnnxRunner", "TfliteRunner"]
