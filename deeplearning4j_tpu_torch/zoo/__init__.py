"""Model zoo: the sequential architectures whose layers the port runs
(the JAX package's ``zoo/``; graph models wait for the ComputationGraph,
``ROADMAP.md`` queue 1 item 9)."""
from .base import PretrainedType, ZooModel
from .models import AlexNet, Darknet19, LeNet, SimpleCNN, VGG16, VGG19

__all__ = ["ZooModel", "PretrainedType", "AlexNet", "Darknet19", "LeNet",
           "SimpleCNN", "VGG16", "VGG19"]
