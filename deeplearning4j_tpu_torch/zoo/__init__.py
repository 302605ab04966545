"""Model zoo: the architectures whose layers the port runs (the JAX
package's ``zoo/``), sequential and graph. TinyYOLO, and the layers that
UNet, Xception, NASNet and YOLO2 need, wait for ``ROADMAP.md`` queue 1
item 9: those four graph models construct and raise at ``init_model()``
naming it."""
from .base import PretrainedType, ZooModel
from .models import (AlexNet, Darknet19, LeNet, SimpleCNN,
                     TextGenerationLSTM, VGG16, VGG19)
from .models_graph import (FaceNetNN4Small2, InceptionResNetV1, NASNet,
                           ResNet50, SqueezeNet, UNet, Xception, YOLO2)

__all__ = ["ZooModel", "PretrainedType", "AlexNet", "Darknet19",
           "FaceNetNN4Small2", "InceptionResNetV1", "LeNet", "NASNet",
           "ResNet50", "SimpleCNN", "SqueezeNet", "TextGenerationLSTM",
           "UNet", "VGG16", "VGG19", "Xception", "YOLO2"]
