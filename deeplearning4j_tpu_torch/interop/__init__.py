"""Foreign-runtime interop: run TF graphs and ONNX models on NDArrays.

Counterpart of ``deeplearning4j_tpu/interop/`` (the reference's
``nd4j-tensorflow`` ``GraphRunner``, ``nd4j-onnxruntime``):
- `GraphRunner`: executes a frozen TF GraphDef through the tensorflow
  runtime when installed, else through the port's own TF importer on
  ``device`` (the card by default);
- `OnnxRunner`: executes ONNX models through the port's importer.

`TfliteRunner` (the JAX package's ``interop/tflite.py``) is not ported
yet (``ROADMAP.md`` queue 1 item 11c-ii) and raises.
"""
from .graph_runner import GraphRunner, OnnxRunner


class TfliteRunner:
    """The float ``.tflite`` runner: not ported yet (item 11c-ii)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TfliteRunner is not ported yet; it waits for ROADMAP.md queue "
            "1 item 11c-ii")


__all__ = ["GraphRunner", "OnnxRunner", "TfliteRunner"]
