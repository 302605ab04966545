"""OmniHub: cache-first pretrained-model resolution + typed loaders.

Reference: `omnihub/src/main/java/org/eclipse/deeplearning4j/omnihub/` —
OmniHubUtils downloads into $HOME/.omnihub, generated namespaces expose
`pretrained().<model>()` accessors returning DL4J/SameDiff models.
Counterpart of ``deeplearning4j_tpu/omnihub/hub.py``: the same registry and
cache-first resolution (nothing is fetched unless a fetcher hook is
installed); every ``kind`` loads through the port's loader onto
``device`` (the card by default).
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, Optional


def _default_cache() -> str:
    return os.environ.get("OMNIHUB_HOME",
                          os.path.join(os.path.expanduser("~"), ".omnihub"))


class OmniHub:
    """Model registry + cache-first resolution.

    `register(name, kind, filename, sha256)` declares an artifact;
    `path(name)` resolves it from the cache (invoking the fetcher hook on
    miss, when one is installed); `load(name)` materializes a framework
    object: kind 'dl4j' -> MultiLayerNetwork via the ModelSerializer-format
    reader, 'samediff' -> SameDiff zip, 'tf' -> imported TF GraphDef,
    'onnx' -> imported ONNX model, 'keras' -> imported h5.
    """

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir or _default_cache()
        self._registry: Dict[str, Dict] = {}
        self.fetcher: Optional[Callable[[str, str], str]] = None

    def register(self, name: str, kind: str, filename: str,
                 sha256: Optional[str] = None):
        self._registry[name] = {"kind": kind, "filename": filename,
                                "sha256": sha256}
        return self

    def models(self):
        return sorted(self._registry)

    def path(self, name: str) -> str:
        meta = self._registry[name]
        local = os.path.join(self.cache_dir, meta["filename"])
        if not os.path.exists(local):
            if self.fetcher is None:
                raise FileNotFoundError(
                    f"{name}: {local} not in cache and no fetcher installed "
                    f"(offline environment — pre-populate the cache)")
            local = self.fetcher(name, meta["filename"])
        want = meta.get("sha256")
        if want:
            h = hashlib.sha256()
            with open(local, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            if h.hexdigest() != want:
                raise ValueError(f"{name}: checksum mismatch")
        return local

    def load(self, name: str, device="cuda", **kwargs):
        meta = self._registry[name]
        path = self.path(name)
        kind = meta["kind"]
        if kind == "dl4j":
            from ..zoo.dl4j_import import restore_multi_layer_network
            return restore_multi_layer_network(path, device=device)
        if kind == "samediff":
            from ..autodiff.samediff import SameDiff
            return SameDiff.load(path, device=device)
        if kind == "tf":
            from ..modelimport import import_tf_graph
            return import_tf_graph(path, device=device, **kwargs)
        if kind == "onnx":
            from ..modelimport import import_onnx_model
            return import_onnx_model(path, device=device, **kwargs)
        if kind == "keras":
            from ..modelimport import \
                import_keras_sequential_model_and_weights
            return import_keras_sequential_model_and_weights(
                path, device=device, **kwargs)
        raise ValueError(f"unknown artifact kind {kind!r}")


hub = OmniHub()
