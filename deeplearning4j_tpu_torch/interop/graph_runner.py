"""GraphRunner: foreign-graph execution on NDArrays.

Counterpart of ``deeplearning4j_tpu/interop/graph_runner.py``. Reference: `nd4j-tensorflow/src/main/java/org/nd4j/tensorflow/conversion/
graphrunner/GraphRunner.java:52` — wraps a TF GraphDef and runs it on
INDArrays. Two backends here:
- "tensorflow": the actual TF runtime (when the wheel is present), matching
  the reference's libtensorflow path bit-for-bit;
- "native": this framework's TF importer — available everywhere, and
  runs the graph on ``device`` (the card unless the caller names
  another).

The "tensorflow" backend imports TF lazily, only when chosen.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ndarray.ndarray import NDArray


class GraphRunner:
    def __init__(self, graph_bytes_or_path,
                 input_names: Optional[Sequence[str]] = None,
                 output_names: Optional[Sequence[str]] = None,
                 input_shapes: Optional[Dict[str, Tuple]] = None,
                 backend: str = "auto", device="cuda"):
        if isinstance(graph_bytes_or_path, (str, os.PathLike)):
            with open(graph_bytes_or_path, "rb") as f:
                graph_bytes_or_path = f.read()
        self._pb = graph_bytes_or_path
        self.input_names = list(input_names) if input_names else None
        self.output_names = list(output_names) if output_names else None
        self.input_shapes = input_shapes
        self.device = device
        self._tf_session = None
        self._native = None
        if backend == "auto":
            backend = "tensorflow" if _has_tf() else "native"
        self.backend = backend

    # -- backends ----------------------------------------------------------
    def _ensure_tf(self):
        if self._tf_session is None:
            import tensorflow as tf
            gd = tf.compat.v1.GraphDef()
            gd.ParseFromString(self._pb)
            graph = tf.Graph()
            with graph.as_default():
                tf.import_graph_def(gd, name="")
            self._tf_session = tf.compat.v1.Session(graph=graph)
        return self._tf_session

    def _ensure_native(self):
        if self._native is None:
            from ..modelimport import import_tf_graph
            self._native = import_tf_graph(
                self._pb, input_shapes=self.input_shapes,
                outputs=self.output_names, device=self.device)
        return self._native

    # -- execution -----------------------------------------------------------
    def run(self, inputs: Dict[str, object]) -> Dict[str, NDArray]:
        """Reference GraphRunner.run(Map<String, INDArray>)."""
        feeds = {k: (v.numpy() if isinstance(v, NDArray) else np.asarray(v))
                 for k, v in inputs.items()}
        if self.backend == "tensorflow":
            sess = self._ensure_tf()
            outs = self.output_names or []
            fetches = [o if ":" in o else o + ":0" for o in outs]
            feed = {(k if ":" in k else k + ":0"): v
                    for k, v in feeds.items()}
            results = sess.run(fetches, feed)
            return {o: NDArray(r) for o, r in zip(outs, results)}
        imp = self._ensure_native()
        res = imp.output(feeds, self.output_names)
        return {k.split(":")[0] if k.endswith(":0") else k: v
                for k, v in res.items()}

    def close(self):
        if self._tf_session is not None:
            self._tf_session.close()
            self._tf_session = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class OnnxRunner:
    """ONNX execution on NDArrays (reference nd4j-onnxruntime OnnxRuntime
    runner) via the native importer, on ``device``."""

    def __init__(self, model_bytes_or_path,
                 input_shapes: Optional[Dict[str, Tuple]] = None,
                 device="cuda"):
        from ..modelimport import import_onnx_model
        self._imp = import_onnx_model(model_bytes_or_path,
                                      input_shapes=input_shapes,
                                      device=device)

    def run(self, inputs: Dict[str, object],
            outputs: Optional[List[str]] = None) -> Dict[str, NDArray]:
        feeds = {k: (v.numpy() if isinstance(v, NDArray) else np.asarray(v))
                 for k, v in inputs.items()}
        return self._imp.output(feeds, outputs)


def _has_tf() -> bool:
    """Whether the tensorflow package is installed, found without
    importing it (only the "tensorflow" backend imports TF)."""
    import importlib.util
    return importlib.util.find_spec("tensorflow") is not None
