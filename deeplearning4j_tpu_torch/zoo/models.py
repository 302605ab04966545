"""Sequential zoo architectures (MultiLayerNetwork-based).

Counterpart of the sequential models of ``deeplearning4j_tpu/zoo/
models.py`` (the reference's ``zoo/model/``): LeNet, SimpleCNN, AlexNet,
VGG16, VGG19, Darknet19, TinyYOLO and TextGenerationLSTM, with the same
configurations, so each model's JSON is the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from ..learning import Adam, Nesterovs
from ..nn.conf.config import InputType, NeuralNetConfiguration
from ..nn.conf.layers import (ActivationLayer, BatchNormalization,
                              ConvolutionLayer, DenseLayer, DropoutLayer,
                              GlobalPoolingLayer, LocalResponseNormalization,
                              LossLayer, LSTM, OutputLayer, RnnOutputLayer,
                              SubsamplingLayer, Yolo2OutputLayer)
from .base import ZooModel


def _conv_bn_leaky(n_out, k=3, stride=1):
    """Darknet conv block: conv (no bias) + BN + leaky-relu
    (reference DarknetHelper.addLayers)."""
    pad = (k - 1) // 2
    return [
        ConvolutionLayer(n_out=n_out, kernel_size=(k, k), stride=(stride, stride),
                         padding=(pad, pad), has_bias=False,
                         activation="identity"),
        BatchNormalization(),
        ActivationLayer(activation="leakyrelu"),
    ]


@dataclasses.dataclass
class LeNet(ZooModel):
    """Reference zoo/model/LeNet.java (MNIST config: 1x28x28)."""
    num_classes: int = 10
    input_shape: Tuple[int, int, int] = (1, 28, 28)

    def conf(self):
        c, h, w = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(Adam(1e-3))
                .list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                        activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                        activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


@dataclasses.dataclass
class SimpleCNN(ZooModel):
    """Reference zoo/model/SimpleCNN.java (4 conv blocks + dense)."""
    num_classes: int = 10
    input_shape: Tuple[int, int, int] = (3, 48, 48)

    def conf(self):
        c, h, w = self.input_shape
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed).updater(Adam(1e-3)).list())
        for n_out in (16, 16, 32, 32):
            b = (b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                          convolution_mode="same",
                                          activation="identity"))
                 .layer(BatchNormalization())
                 .layer(ActivationLayer(activation="relu"))
                 .layer(SubsamplingLayer(kernel_size=(2, 2))))
        return (b.layer(DenseLayer(n_out=64, activation="relu"))
                .layer(DropoutLayer(rate=0.5))
                .layer(OutputLayer(n_out=self.num_classes))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


@dataclasses.dataclass
class AlexNet(ZooModel):
    """Reference zoo/model/AlexNet.java (one-tower variant w/ LRN)."""
    num_classes: int = 1000
    input_shape: Tuple[int, int, int] = (3, 224, 224)

    def conf(self):
        c, h, w = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).updater(Nesterovs(1e-2, 0.9)).l2(5e-4)
                .list()
                .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11),
                                        stride=(4, 4), activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                                        padding=(2, 2), activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        padding=(1, 1), activation="relu"))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        padding=(1, 1), activation="relu"))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                        padding=(1, 1), activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(n_out=4096, activation="relu"))
                .layer(DropoutLayer(rate=0.5))
                .layer(DenseLayer(n_out=4096, activation="relu"))
                .layer(DropoutLayer(rate=0.5))
                .layer(OutputLayer(n_out=self.num_classes))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


def _vgg_conf(blocks: Sequence[Tuple[int, int]], seed, num_classes, input_shape):
    """VGG stack: blocks of (num_convs, channels) then 3 dense layers."""
    c, h, w = input_shape
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater(Nesterovs(1e-2, 0.9)).list())
    for n_convs, ch in blocks:
        for _ in range(n_convs):
            b = b.layer(ConvolutionLayer(n_out=ch, kernel_size=(3, 3),
                                         padding=(1, 1), activation="relu"))
        b = b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
    return (b.layer(DenseLayer(n_out=4096, activation="relu"))
            .layer(DropoutLayer(rate=0.5))
            .layer(DenseLayer(n_out=4096, activation="relu"))
            .layer(DropoutLayer(rate=0.5))
            .layer(OutputLayer(n_out=num_classes))
            .set_input_type(InputType.convolutional(h, w, c))
            .build())


@dataclasses.dataclass
class VGG16(ZooModel):
    """Reference zoo/model/VGG16.java."""

    def conf(self):
        return _vgg_conf([(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)],
                         self.seed, self.num_classes, self.input_shape)


@dataclasses.dataclass
class VGG19(ZooModel):
    """Reference zoo/model/VGG19.java."""

    def conf(self):
        return _vgg_conf([(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)],
                         self.seed, self.num_classes, self.input_shape)


@dataclasses.dataclass
class Darknet19(ZooModel):
    """Reference zoo/model/Darknet19.java (YOLO9000 backbone)."""
    num_classes: int = 1000
    input_shape: Tuple[int, int, int] = (3, 224, 224)

    def conf(self):
        c, h, w = self.input_shape
        layers = _conv_bn_leaky(32) + [SubsamplingLayer(kernel_size=(2, 2),
                                                        stride=(2, 2))]
        layers += _conv_bn_leaky(64) + [SubsamplingLayer(kernel_size=(2, 2),
                                                         stride=(2, 2))]
        for ch in (128, 256, 512):
            layers += _conv_bn_leaky(ch) + _conv_bn_leaky(ch // 2, k=1) \
                + _conv_bn_leaky(ch)
            if ch == 512:
                layers += _conv_bn_leaky(ch // 2, k=1) + _conv_bn_leaky(ch)
            layers.append(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        layers += _conv_bn_leaky(1024) + _conv_bn_leaky(512, k=1) \
            + _conv_bn_leaky(1024) + _conv_bn_leaky(512, k=1) \
            + _conv_bn_leaky(1024)
        layers += [ConvolutionLayer(n_out=self.num_classes, kernel_size=(1, 1)),
                   GlobalPoolingLayer(pooling_type="avg"),
                   LossLayer(loss="mcxent", activation="softmax")]
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed).updater(Nesterovs(1e-3, 0.9)).list())
        for layer in layers:
            b = b.layer(layer)
        return b.set_input_type(InputType.convolutional(h, w, c)).build()


#: VOC anchors of the reference TinyYOLO and YOLO2 priors
_TINY_YOLO_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                      (9.42, 5.11), (16.62, 10.52))
_YOLO2_ANCHORS = ((0.57273, 0.677385), (1.87446, 2.06253),
                  (3.33843, 5.47434), (7.88282, 3.52778),
                  (9.77052, 9.16828))


@dataclasses.dataclass
class TinyYOLO(ZooModel):
    """Reference zoo/model/TinyYOLO.java (9-conv darknet + YOLO2 head).

    Its head is a ``Yolo2OutputLayer``, which ``MultiLayerNetwork.fit``
    refuses as the JAX package's does ("last layer must be an
    output/loss layer"; ``ROADMAP.md`` queue 3, reference fault 7):
    ``output()`` runs, training goes through ``YOLO2``'s graph."""
    num_classes: int = 20
    input_shape: Tuple[int, int, int] = (3, 416, 416)

    def conf(self):
        c, h, w = self.input_shape
        layers = []
        for ch in (16, 32, 64, 128, 256):
            layers += _conv_bn_leaky(ch) + [
                SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2))]
        # reference TinyYOLO.java: stride-1 SAME maxpool after the 512 block
        layers += _conv_bn_leaky(512) + [
            SubsamplingLayer(kernel_size=(2, 2), stride=(1, 1),
                             padding="SAME")]
        layers += _conv_bn_leaky(1024) + _conv_bn_leaky(1024)
        layers += [ConvolutionLayer(
            n_out=len(_TINY_YOLO_ANCHORS) * (5 + self.num_classes),
            kernel_size=(1, 1)), Yolo2OutputLayer(anchors=_TINY_YOLO_ANCHORS)]
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed).updater(Adam(1e-3)).list())
        for layer in layers:
            b = b.layer(layer)
        return b.set_input_type(InputType.convolutional(h, w, c)).build()


@dataclasses.dataclass
class TextGenerationLSTM(ZooModel):
    """Reference zoo/model/TextGenerationLSTM.java (char-level
    2 x LSTM-256)."""
    num_classes: int = 77          # totalUniqueCharacters
    max_length: int = 40
    input_shape: Tuple[int, int] = (77, 40)  # (features, timesteps)

    def conf(self):
        feat, t = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).updater(Adam(1e-3))
                .gradient_normalization("clip_value", 10.0)
                .list()
                .layer(LSTM(n_in=feat, n_out=256, activation="tanh"))
                .layer(LSTM(n_in=256, n_out=256, activation="tanh"))
                .layer(DropoutLayer(rate=0.5))
                .layer(RnnOutputLayer(n_in=256, n_out=self.num_classes,
                                      loss="mcxent", activation="softmax"))
                .set_input_type(InputType.recurrent(feat, t))
                .build())
