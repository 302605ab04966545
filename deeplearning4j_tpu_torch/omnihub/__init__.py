"""omnihub: model-hub abstraction (reference `omnihub/` module).

Reference: omnihub downloads pretrained DL4J/SameDiff artifacts from a
configured hub URL into a local cache and exposes namespaced accessors.
Zero-egress environments pre-populate the cache directory; resolution is
cache-first with an optional fetcher hook (same pattern as
zoo.weights_fetcher). Counterpart of ``deeplearning4j_tpu/omnihub/``;
``OmniHub.load(name, device=...)`` loads onto the card by default.
"""
from .hub import OmniHub, hub

__all__ = ["OmniHub", "hub"]
