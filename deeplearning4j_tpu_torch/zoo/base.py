"""Zoo base: named architectures over the configuration DSL.

Counterpart of ``deeplearning4j_tpu/zoo/base.py`` (the reference's
``ZooModel``). ``init_model(device=...)`` builds and initializes the
network with random weights from ``seed``. No pretrained weights ship
with the port and it fetches none: ``init_pretrained`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


class PretrainedType:
    IMAGENET = "imagenet"
    MNIST = "mnist"
    CIFAR10 = "cifar10"
    VGGFACE = "vggface"
    SEGMENT = "segment"


@dataclasses.dataclass
class ZooModel:
    """Base class for zoo architectures (reference zoo/ZooModel.java)."""
    num_classes: int = 1000
    seed: int = 123
    input_shape: Tuple[int, int, int] = (3, 224, 224)  # (C, H, W)
    #: compute dtype of the built network ("bfloat16": bf16 body with f32
    #: masters, see the configuration's dtype)
    dtype: str = "float32"

    def conf(self):
        raise NotImplementedError

    def build_conf(self):
        """``self.conf()`` with the zoo-level dtype applied."""
        conf = self.conf()
        if self.dtype and self.dtype != "float32":
            conf.dtype = self.dtype
        return conf

    def init_model(self, device="cuda"):
        """Build + init the network on ``device``."""
        from ..nn.multilayer import MultiLayerNetwork
        return MultiLayerNetwork(self.build_conf(), device=device).init()

    def pretrained_available(self, ptype: str = PretrainedType.IMAGENET) -> bool:
        return False

    def init_pretrained(self, ptype: str = PretrainedType.IMAGENET,
                        path=None):
        raise NotImplementedError(
            f"{type(self).__name__}: the port ships no pretrained weights "
            "and fetches none; reading DL4J or JAX-package checkpoints "
            "waits for nn/serde.py (ROADMAP.md queue 1 item 9)")
