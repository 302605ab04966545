"""Model zoo: the JAX package's ``zoo/`` architectures, sequential and
graph."""
from .base import PretrainedType, ZooModel
from .models import (AlexNet, Darknet19, LeNet, SimpleCNN,
                     TextGenerationLSTM, TinyYOLO, VGG16, VGG19)
from .models_graph import (FaceNetNN4Small2, InceptionResNetV1, NASNet,
                           ResNet50, SqueezeNet, UNet, Xception, YOLO2)

__all__ = ["ZooModel", "PretrainedType", "AlexNet", "Darknet19",
           "FaceNetNN4Small2", "InceptionResNetV1", "LeNet", "NASNet",
           "ResNet50", "SimpleCNN", "SqueezeNet", "TextGenerationLSTM",
           "TinyYOLO", "UNet", "VGG16", "VGG19", "Xception", "YOLO2"]
