"""Graph zoo architectures (ComputationGraph-based).

Counterpart of ``deeplearning4j_tpu/zoo/models_graph.py`` (the
reference's ``zoo/model/`` ResNet50, SqueezeNet, UNet, Xception,
InceptionResNetV1, FaceNetNN4Small2, NASNet and YOLO2), with the same
configurations, so each model's JSON is the JAX package's: UNet
(``Upsampling2D``, ``CnnLossLayer``), Xception and NASNet
(``SeparableConvolution2D``) and YOLO2 (``SpaceToDepthLayer``,
``Yolo2OutputLayer``) among them.

Block-repeat counts are parameters, so tests build tiny variants; the
defaults are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from ..learning import Adam, Nesterovs
from ..nn.conf.config import InputType, NeuralNetConfiguration
from ..nn.conf.layers import (ActivationLayer, BatchNormalization,
                              CnnLossLayer, ConvolutionLayer, DenseLayer,
                              DropoutLayer, GlobalPoolingLayer, LossLayer,
                              OutputLayer, SeparableConvolution2D,
                              SpaceToDepthLayer, SubsamplingLayer,
                              Upsampling2D, Yolo2OutputLayer)
from ..nn.graph import (ComputationGraph, ElementWiseVertex,
                        L2NormalizeVertex, MergeVertex, ScaleVertex)
from .base import ZooModel
from .models import _YOLO2_ANCHORS, _conv_bn_leaky


@dataclasses.dataclass
class _GraphModel(ZooModel):
    """A zoo architecture built as a ComputationGraph."""

    def init_model(self, device="cuda") -> ComputationGraph:
        """Build + init the graph on ``device``."""
        return ComputationGraph(self.build_conf(), device=device).init()


class _G:
    """Small helper around GraphBuilder: tracks the previous vertex name."""

    def __init__(self, builder, inp):
        self.b = builder
        self.last = inp

    def layer(self, name, layer, *inputs):
        self.b.add_layer(name, layer, *(inputs or (self.last,)))
        self.last = name
        return name

    def vertex(self, name, vertex, *inputs):
        self.b.add_vertex(name, vertex, *(inputs or (self.last,)))
        self.last = name
        return name

    def conv_bn(self, prefix, n_out, k=(3, 3), stride=(1, 1), pad=None,
                activation="relu", inputs=None, mode=None):
        kw = {}
        if pad is not None:
            kw["padding"] = pad
        if mode is not None:
            kw["convolution_mode"] = mode
        c = self.layer(f"{prefix}_conv",
                       ConvolutionLayer(n_out=n_out, kernel_size=k,
                                        stride=stride, has_bias=False,
                                        activation="identity", **kw),
                       *(inputs or ()))
        self.layer(f"{prefix}_bn", BatchNormalization(), c)
        if activation:
            self.layer(f"{prefix}_act", ActivationLayer(activation=activation))
        return self.last


def _graph_builder(zoo: ZooModel, updater):
    c, h, w = zoo.input_shape
    b = (NeuralNetConfiguration.builder()
         .seed(zoo.seed).updater(updater)
         .graph_builder()
         .add_inputs("input")
         .set_input_types(InputType.convolutional(h, w, c)))
    return b


@dataclasses.dataclass
class ResNet50(_GraphModel):
    """Reference zoo/model/ResNet50.java — bottleneck v1, stages [3,4,6,3]."""
    stages: Sequence[int] = (3, 4, 6, 3)

    def conf(self):
        b = _graph_builder(self, Nesterovs(1e-1, 0.9))
        g = _G(b, "input")
        g.conv_bn("stem", 64, k=(7, 7), stride=(2, 2), pad=(3, 3))
        g.layer("stem_pool", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                              padding=(1, 1)))

        filters = [(64, 256), (128, 512), (256, 1024), (512, 2048)]
        for stage, (n_blocks, (f_in, f_out)) in enumerate(
                zip(self.stages, filters)):
            for block in range(n_blocks):
                stride = (2, 2) if (stage > 0 and block == 0) else (1, 1)
                p = f"s{stage}b{block}"
                shortcut_src = g.last
                if block == 0:
                    shortcut = g.conv_bn(f"{p}_sc", f_out, k=(1, 1),
                                         stride=stride, activation=None,
                                         inputs=(shortcut_src,))
                else:
                    shortcut = shortcut_src
                g.conv_bn(f"{p}_a", f_in, k=(1, 1), stride=stride,
                          inputs=(shortcut_src,))
                g.conv_bn(f"{p}_b", f_in, k=(3, 3), pad=(1, 1))
                g.conv_bn(f"{p}_c", f_out, k=(1, 1), activation=None)
                g.vertex(f"{p}_add", ElementWiseVertex(op="add"),
                         g.last, shortcut)
                g.layer(f"{p}_out", ActivationLayer(activation="relu"))

        g.layer("avgpool", GlobalPoolingLayer(pooling_type="avg"))
        g.layer("output", OutputLayer(n_out=self.num_classes))
        b.set_outputs("output")
        return b.build()


@dataclasses.dataclass
class SqueezeNet(_GraphModel):
    """Reference zoo/model/SqueezeNet.java (v1.1 fire modules)."""

    def _fire(self, g, p, squeeze, expand):
        g.layer(f"{p}_sq", ConvolutionLayer(n_out=squeeze, kernel_size=(1, 1),
                                            activation="relu"))
        sq = g.last
        e1 = g.layer(f"{p}_e1", ConvolutionLayer(n_out=expand, kernel_size=(1, 1),
                                                 activation="relu"), sq)
        e3 = g.layer(f"{p}_e3", ConvolutionLayer(n_out=expand, kernel_size=(3, 3),
                                                 padding=(1, 1),
                                                 activation="relu"), sq)
        g.vertex(f"{p}_merge", MergeVertex(), e1, e3)

    def conf(self):
        b = _graph_builder(self, Adam(1e-3))
        g = _G(b, "input")
        g.layer("conv1", ConvolutionLayer(n_out=64, kernel_size=(3, 3),
                                          stride=(2, 2), activation="relu"))
        g.layer("pool1", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
        self._fire(g, "fire2", 16, 64)
        self._fire(g, "fire3", 16, 64)
        g.layer("pool3", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
        self._fire(g, "fire4", 32, 128)
        self._fire(g, "fire5", 32, 128)
        g.layer("pool5", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
        self._fire(g, "fire6", 48, 192)
        self._fire(g, "fire7", 48, 192)
        self._fire(g, "fire8", 64, 256)
        self._fire(g, "fire9", 64, 256)
        g.layer("drop9", DropoutLayer(rate=0.5))
        g.layer("conv10", ConvolutionLayer(n_out=self.num_classes,
                                           kernel_size=(1, 1),
                                           activation="relu"))
        g.layer("avgpool", GlobalPoolingLayer(pooling_type="avg"))
        g.layer("loss", LossLayer(loss="mcxent", activation="softmax"))
        b.set_outputs("loss")
        return b.build()


@dataclasses.dataclass
class UNet(_GraphModel):
    """Reference zoo/model/UNet.java (biomedical segmentation, 512x512)."""
    input_shape: Tuple[int, int, int] = (3, 512, 512)
    base_filters: int = 64

    def conf(self):
        b = _graph_builder(self, Adam(1e-4))
        g = _G(b, "input")
        f = self.base_filters
        skips = []
        # contracting path
        for i, ch in enumerate((f, f * 2, f * 4, f * 8)):
            g.layer(f"d{i}_c1", ConvolutionLayer(n_out=ch, kernel_size=(3, 3),
                                                 padding=(1, 1),
                                                 activation="relu"))
            g.layer(f"d{i}_c2", ConvolutionLayer(n_out=ch, kernel_size=(3, 3),
                                                 padding=(1, 1),
                                                 activation="relu"))
            skips.append(g.last)
            g.layer(f"d{i}_pool", SubsamplingLayer(kernel_size=(2, 2),
                                                   stride=(2, 2)))
        # bottom
        g.layer("bottom_c1", ConvolutionLayer(n_out=f * 16, kernel_size=(3, 3),
                                              padding=(1, 1), activation="relu"))
        g.layer("bottom_drop", DropoutLayer(rate=0.5))
        g.layer("bottom_c2", ConvolutionLayer(n_out=f * 16, kernel_size=(3, 3),
                                              padding=(1, 1), activation="relu"))
        # expanding path
        for i, ch in enumerate((f * 8, f * 4, f * 2, f)):
            g.layer(f"u{i}_up", Upsampling2D(size=2))
            g.layer(f"u{i}_upconv", ConvolutionLayer(n_out=ch, kernel_size=(2, 2),
                                                     convolution_mode="same",
                                                     activation="relu"))
            g.vertex(f"u{i}_merge", MergeVertex(), skips[-(i + 1)], g.last)
            g.layer(f"u{i}_c1", ConvolutionLayer(n_out=ch, kernel_size=(3, 3),
                                                 padding=(1, 1),
                                                 activation="relu"))
            g.layer(f"u{i}_c2", ConvolutionLayer(n_out=ch, kernel_size=(3, 3),
                                                 padding=(1, 1),
                                                 activation="relu"))
        g.layer("final_conv", ConvolutionLayer(n_out=1, kernel_size=(1, 1),
                                               activation="identity"))
        g.layer("loss", CnnLossLayer(loss="xent", activation="sigmoid"))
        b.set_outputs("loss")
        return b.build()


@dataclasses.dataclass
class Xception(_GraphModel):
    """Reference zoo/model/Xception.java (entry/middle/exit flows)."""
    middle_blocks: int = 8

    def _sep_bn(self, g, p, n_out, act_first=True, inputs=None):
        if act_first:
            g.layer(f"{p}_pre", ActivationLayer(activation="relu"),
                    *(inputs or ()))
            inputs = None
        g.layer(f"{p}_sep", SeparableConvolution2D(n_out=n_out,
                                                   kernel_size=(3, 3),
                                                   convolution_mode="same",
                                                   has_bias=False,
                                                   activation="identity"),
                *(inputs or ()))
        g.layer(f"{p}_bn", BatchNormalization())

    def conf(self):
        b = _graph_builder(self, Nesterovs(0.045, 0.9))
        g = _G(b, "input")
        g.conv_bn("b1a", 32, k=(3, 3), stride=(2, 2))
        g.conv_bn("b1b", 64, k=(3, 3))
        # entry-flow residual blocks
        for p, ch in (("b2", 128), ("b3", 256), ("b4", 728)):
            res_src = g.last
            sc = g.conv_bn(f"{p}_sc", ch, k=(1, 1), stride=(2, 2),
                           activation=None, inputs=(res_src,))
            self._sep_bn(g, f"{p}_s1", ch, act_first=(p != "b2"),
                         inputs=(res_src,))
            self._sep_bn(g, f"{p}_s2", ch)
            g.layer(f"{p}_pool", SubsamplingLayer(kernel_size=(3, 3),
                                                  stride=(2, 2),
                                                  padding=(1, 1)))
            g.vertex(f"{p}_add", ElementWiseVertex(op="add"), g.last, sc)
        # middle flow
        for i in range(self.middle_blocks):
            src = g.last
            for j in range(3):
                self._sep_bn(g, f"mid{i}_{j}", 728)
            g.vertex(f"mid{i}_add", ElementWiseVertex(op="add"), g.last, src)
        # exit flow
        src = g.last
        sc = g.conv_bn("exit_sc", 1024, k=(1, 1), stride=(2, 2),
                       activation=None, inputs=(src,))
        self._sep_bn(g, "exit_s1", 728, inputs=(src,))
        self._sep_bn(g, "exit_s2", 1024)
        g.layer("exit_pool", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                              padding=(1, 1)))
        g.vertex("exit_add", ElementWiseVertex(op="add"), g.last, sc)
        self._sep_bn(g, "exit_s3", 1536, act_first=False)
        g.layer("exit_act3", ActivationLayer(activation="relu"))
        self._sep_bn(g, "exit_s4", 2048, act_first=False)
        g.layer("exit_act4", ActivationLayer(activation="relu"))
        g.layer("avgpool", GlobalPoolingLayer(pooling_type="avg"))
        g.layer("output", OutputLayer(n_out=self.num_classes))
        b.set_outputs("output")
        return b.build()


@dataclasses.dataclass
class InceptionResNetV1(_GraphModel):
    """Reference zoo/model/InceptionResNetV1.java (+ InceptionResNetHelper):
    stem → 5x block35 → reduction-A → 10x block17 → reduction-B → 5x block8
    → avgpool → dropout → bottleneck → softmax."""
    blocks: Tuple[int, int, int] = (5, 10, 5)
    embedding_size: int = 128
    input_shape: Tuple[int, int, int] = (3, 160, 160)

    def _block35(self, g, p, scale=0.17):
        src = g.last
        b0 = g.conv_bn(f"{p}_b0", 32, k=(1, 1), inputs=(src,))
        g.conv_bn(f"{p}_b1a", 32, k=(1, 1), inputs=(src,))
        b1 = g.conv_bn(f"{p}_b1b", 32, k=(3, 3), pad=(1, 1))
        g.conv_bn(f"{p}_b2a", 32, k=(1, 1), inputs=(src,))
        g.conv_bn(f"{p}_b2b", 32, k=(3, 3), pad=(1, 1))
        b2 = g.conv_bn(f"{p}_b2c", 32, k=(3, 3), pad=(1, 1))
        g.vertex(f"{p}_cat", MergeVertex(), b0, b1, b2)
        g.layer(f"{p}_up", ConvolutionLayer(n_out=256, kernel_size=(1, 1),
                                            activation="identity"))
        g.vertex(f"{p}_scale", ScaleVertex(scale=scale))
        g.vertex(f"{p}_add", ElementWiseVertex(op="add"), src, g.last)
        g.layer(f"{p}_act", ActivationLayer(activation="relu"))

    def _block17(self, g, p, scale=0.10):
        src = g.last
        b0 = g.conv_bn(f"{p}_b0", 128, k=(1, 1), inputs=(src,))
        g.conv_bn(f"{p}_b1a", 128, k=(1, 1), inputs=(src,))
        g.conv_bn(f"{p}_b1b", 128, k=(1, 7), pad=(0, 3))
        b1 = g.conv_bn(f"{p}_b1c", 128, k=(7, 1), pad=(3, 0))
        g.vertex(f"{p}_cat", MergeVertex(), b0, b1)
        g.layer(f"{p}_up", ConvolutionLayer(n_out=896, kernel_size=(1, 1),
                                            activation="identity"))
        g.vertex(f"{p}_scale", ScaleVertex(scale=scale))
        g.vertex(f"{p}_add", ElementWiseVertex(op="add"), src, g.last)
        g.layer(f"{p}_act", ActivationLayer(activation="relu"))

    def _block8(self, g, p, scale=0.20):
        src = g.last
        b0 = g.conv_bn(f"{p}_b0", 192, k=(1, 1), inputs=(src,))
        g.conv_bn(f"{p}_b1a", 192, k=(1, 1), inputs=(src,))
        g.conv_bn(f"{p}_b1b", 192, k=(1, 3), pad=(0, 1))
        b1 = g.conv_bn(f"{p}_b1c", 192, k=(3, 1), pad=(1, 0))
        g.vertex(f"{p}_cat", MergeVertex(), b0, b1)
        g.layer(f"{p}_up", ConvolutionLayer(n_out=1792, kernel_size=(1, 1),
                                            activation="identity"))
        g.vertex(f"{p}_scale", ScaleVertex(scale=scale))
        g.vertex(f"{p}_add", ElementWiseVertex(op="add"), src, g.last)
        g.layer(f"{p}_act", ActivationLayer(activation="relu"))

    def conf(self):
        b = _graph_builder(self, Adam(1e-3))
        g = _G(b, "input")
        # stem
        g.conv_bn("stem1", 32, k=(3, 3), stride=(2, 2))
        g.conv_bn("stem2", 32, k=(3, 3))
        g.conv_bn("stem3", 64, k=(3, 3), pad=(1, 1))
        g.layer("stem_pool", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
        g.conv_bn("stem4", 80, k=(1, 1))
        g.conv_bn("stem5", 192, k=(3, 3))
        g.conv_bn("stem6", 256, k=(3, 3), stride=(2, 2))
        for i in range(self.blocks[0]):
            self._block35(g, f"b35_{i}")
        # reduction-A → 896 channels
        src = g.last
        r0 = g.conv_bn("redA_b0", 384, k=(3, 3), stride=(2, 2), inputs=(src,))
        g.conv_bn("redA_b1a", 192, k=(1, 1), inputs=(src,))
        g.conv_bn("redA_b1b", 192, k=(3, 3), pad=(1, 1))
        r1 = g.conv_bn("redA_b1c", 256, k=(3, 3), stride=(2, 2))
        r2 = g.layer("redA_pool", SubsamplingLayer(kernel_size=(3, 3),
                                                   stride=(2, 2)), src)
        g.vertex("redA_cat", MergeVertex(), r0, r1, r2)
        for i in range(self.blocks[1]):
            self._block17(g, f"b17_{i}")
        # reduction-B → 1792 channels
        src = g.last
        g.conv_bn("redB_b0a", 256, k=(1, 1), inputs=(src,))
        r0 = g.conv_bn("redB_b0b", 384, k=(3, 3), stride=(2, 2))
        g.conv_bn("redB_b1a", 256, k=(1, 1), inputs=(src,))
        r1 = g.conv_bn("redB_b1b", 256, k=(3, 3), stride=(2, 2))
        g.conv_bn("redB_b2a", 256, k=(1, 1), inputs=(src,))
        g.conv_bn("redB_b2b", 256, k=(3, 3), pad=(1, 1))
        r2 = g.conv_bn("redB_b2c", 256, k=(3, 3), stride=(2, 2))
        r3 = g.layer("redB_pool", SubsamplingLayer(kernel_size=(3, 3),
                                                   stride=(2, 2)), src)
        g.vertex("redB_cat", MergeVertex(), r0, r1, r2, r3)
        for i in range(self.blocks[2]):
            self._block8(g, f"b8_{i}")
        g.layer("avgpool", GlobalPoolingLayer(pooling_type="avg"))
        g.layer("drop", DropoutLayer(rate=0.2))
        g.layer("bottleneck", DenseLayer(n_out=self.embedding_size,
                                         activation="identity"))
        g.vertex("embeddings", L2NormalizeVertex())
        g.layer("output", OutputLayer(n_in=self.embedding_size,
                                      n_out=self.num_classes), "bottleneck")
        b.set_outputs("output")
        return b.build()


@dataclasses.dataclass
class FaceNetNN4Small2(_GraphModel):
    """Reference zoo/model/FaceNetNN4Small2.java (+ FaceNetHelper inception
    blocks), nn4.small2 OpenFace variant, L2-normalized 128-d embeddings."""
    embedding_size: int = 128
    input_shape: Tuple[int, int, int] = (3, 96, 96)

    def _inception(self, g, p, c1, c3r, c3, c5r, c5, pool_proj,
                   pool_type="max"):
        src = g.last
        outs = []
        if c1:
            outs.append(g.conv_bn(f"{p}_1x1", c1, k=(1, 1), inputs=(src,)))
        g.conv_bn(f"{p}_3x3r", c3r, k=(1, 1), inputs=(src,))
        outs.append(g.conv_bn(f"{p}_3x3", c3, k=(3, 3), pad=(1, 1)))
        if c5r:
            g.conv_bn(f"{p}_5x5r", c5r, k=(1, 1), inputs=(src,))
            outs.append(g.conv_bn(f"{p}_5x5", c5, k=(5, 5), pad=(2, 2)))
        g.layer(f"{p}_pool", SubsamplingLayer(pooling_type=pool_type,
                                              kernel_size=(3, 3),
                                              stride=(1, 1), padding=(1, 1)),
                src)
        if pool_proj:
            outs.append(g.conv_bn(f"{p}_poolproj", pool_proj, k=(1, 1)))
        else:
            outs.append(g.last)
        g.vertex(f"{p}_cat", MergeVertex(), *outs)

    def conf(self):
        b = _graph_builder(self, Adam(1e-3))
        g = _G(b, "input")
        g.conv_bn("conv1", 64, k=(7, 7), stride=(2, 2), pad=(3, 3))
        g.layer("pool1", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                          padding=(1, 1)))
        g.conv_bn("conv2", 64, k=(1, 1))
        g.conv_bn("conv3", 192, k=(3, 3), pad=(1, 1))
        g.layer("pool3", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                          padding=(1, 1)))
        self._inception(g, "inc3a", 64, 96, 128, 16, 32, 32)
        self._inception(g, "inc3b", 64, 96, 128, 32, 64, 64)
        g.layer("pool4", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                          padding=(1, 1)))
        self._inception(g, "inc4a", 256, 96, 192, 32, 64, 128)
        self._inception(g, "inc4e", 0, 160, 256, 64, 128, 0)
        g.layer("pool5", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                          padding=(1, 1)))
        self._inception(g, "inc5a", 256, 96, 384, 0, 0, 96, pool_type="avg")
        self._inception(g, "inc5b", 256, 96, 384, 0, 0, 96)
        g.layer("avgpool", GlobalPoolingLayer(pooling_type="avg"))
        g.layer("bottleneck", DenseLayer(n_out=self.embedding_size,
                                         activation="identity"))
        g.vertex("embeddings", L2NormalizeVertex())
        g.layer("output", OutputLayer(n_in=self.embedding_size,
                                      n_out=self.num_classes), "bottleneck")
        b.set_outputs("output")
        return b.build()


@dataclasses.dataclass
class NASNet(_GraphModel):
    """Reference zoo/model/NASNet.java (+ NASNetHelper) — NASNet-A mobile:
    stem → [normal xN, reduction] x3 stacks with penultimate_filters."""
    num_blocks: int = 4
    penultimate_filters: int = 1056
    input_shape: Tuple[int, int, int] = (3, 224, 224)

    def _sep_block(self, g, p, n_out, k, stride=(1, 1), inputs=None):
        """relu → sepconv → bn (x2, second always stride 1) — NASNetHelper.sepConvBlock."""
        g.layer(f"{p}_act1", ActivationLayer(activation="relu"),
                *(inputs or ()))
        g.layer(f"{p}_sep1", SeparableConvolution2D(
            n_out=n_out, kernel_size=k, stride=stride,
            convolution_mode="same", has_bias=False, activation="identity"))
        g.layer(f"{p}_bn1", BatchNormalization())
        g.layer(f"{p}_act2", ActivationLayer(activation="relu"))
        g.layer(f"{p}_sep2", SeparableConvolution2D(
            n_out=n_out, kernel_size=k, convolution_mode="same",
            has_bias=False, activation="identity"))
        g.layer(f"{p}_bn2", BatchNormalization())
        return g.last

    def _adjust(self, g, p, x, filters, stride=(1, 1)):
        """1x1 projection so branch inputs agree in channels/size."""
        g.layer(f"{p}_act", ActivationLayer(activation="relu"), x)
        g.layer(f"{p}_proj", ConvolutionLayer(n_out=filters, kernel_size=(1, 1),
                                              stride=stride, has_bias=False,
                                              activation="identity"))
        g.layer(f"{p}_bn", BatchNormalization())
        return g.last

    def _normal_cell(self, g, p, prev, cur, filters):
        h = self._adjust(g, f"{p}_adjc", cur, filters)
        hp = self._adjust(g, f"{p}_adjp", prev, filters)
        b1a = self._sep_block(g, f"{p}_b1a", filters, (5, 5), inputs=(h,))
        b1 = g.vertex(f"{p}_add1", ElementWiseVertex(op="add"), b1a, h)
        b2a = self._sep_block(g, f"{p}_b2a", filters, (5, 5), inputs=(hp,))
        b2b = self._sep_block(g, f"{p}_b2b", filters, (3, 3), inputs=(h,))
        b2 = g.vertex(f"{p}_add2", ElementWiseVertex(op="add"), b2a, b2b)
        p1 = g.layer(f"{p}_pool1", SubsamplingLayer(pooling_type="avg",
                                                    kernel_size=(3, 3),
                                                    stride=(1, 1),
                                                    padding=(1, 1)), h)
        b3 = g.vertex(f"{p}_add3", ElementWiseVertex(op="add"), p1, hp)
        b4a = self._sep_block(g, f"{p}_b4a", filters, (3, 3), inputs=(hp,))
        b4 = g.vertex(f"{p}_add4", ElementWiseVertex(op="add"), b4a, hp)
        g.vertex(f"{p}_cat", MergeVertex(), b1, b2, b3, b4, hp)
        return cur, g.last

    def _reduction_cell(self, g, p, prev, cur, filters):
        h = self._adjust(g, f"{p}_adjc", cur, filters)
        hp = self._adjust(g, f"{p}_adjp", prev, filters, stride=(2, 2))
        b1a = self._sep_block(g, f"{p}_b1a", filters, (5, 5), stride=(2, 2),
                              inputs=(h,))
        b1 = g.vertex(f"{p}_add1", ElementWiseVertex(op="add"), b1a, hp)
        p1 = g.layer(f"{p}_pool1", SubsamplingLayer(kernel_size=(3, 3),
                                                    stride=(2, 2),
                                                    padding=(1, 1)), h)
        b2a = self._sep_block(g, f"{p}_b2a", filters, (7, 7), stride=(2, 2),
                              inputs=(h,))
        b2 = g.vertex(f"{p}_add2", ElementWiseVertex(op="add"), p1, b2a)
        b3a = self._sep_block(g, f"{p}_b3a", filters, (3, 3), stride=(2, 2),
                              inputs=(h,))
        g.vertex(f"{p}_cat", MergeVertex(), b1, b2, b3a)
        # spatial dims halved: carry the reduced output as both inputs of the
        # next cell (stands in for the reference's factorized-reduction adjust)
        return g.last, g.last

    def conf(self):
        b = _graph_builder(self, Nesterovs(0.045, 0.9))
        g = _G(b, "input")
        f = self.penultimate_filters // 24  # NASNet filter bookkeeping
        g.layer("stem_conv", ConvolutionLayer(n_out=f * 2, kernel_size=(3, 3),
                                              stride=(2, 2), has_bias=False,
                                              activation="identity"))
        g.layer("stem_bn", BatchNormalization())
        prev = cur = g.last
        for stack in range(3):
            mult = 2 ** stack
            for i in range(self.num_blocks):
                prev, cur = self._normal_cell(g, f"s{stack}n{i}", prev, cur,
                                              f * mult)
            if stack < 2:
                prev, cur = self._reduction_cell(g, f"s{stack}r", prev, cur,
                                                 f * mult * 2)
        g.layer("final_act", ActivationLayer(activation="relu"), cur)
        g.layer("avgpool", GlobalPoolingLayer(pooling_type="avg"))
        g.layer("output", OutputLayer(n_out=self.num_classes))
        b.set_outputs("output")
        return b.build()


@dataclasses.dataclass
class YOLO2(_GraphModel):
    """Reference zoo/model/YOLO2.java — Darknet19 backbone + passthrough
    (SpaceToDepth merge) + detection head."""
    num_classes: int = 20
    input_shape: Tuple[int, int, int] = (3, 416, 416)

    def conf(self):
        n_boxes = len(_YOLO2_ANCHORS)
        b = _graph_builder(self, Adam(1e-3))
        g = _G(b, "input")

        def dark(p, n_out, k=3, stride=1):
            for i, l in enumerate(_conv_bn_leaky(n_out, k, stride)):
                g.layer(f"{p}_{i}", l)
            return g.last

        dark("c1", 32)
        g.layer("p1", SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        dark("c2", 64)
        g.layer("p2", SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        dark("c3", 128); dark("c4", 64, k=1); dark("c5", 128)
        g.layer("p3", SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        dark("c6", 256); dark("c7", 128, k=1); dark("c8", 256)
        g.layer("p4", SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        dark("c9", 512); dark("c10", 256, k=1); dark("c11", 512)
        dark("c12", 256, k=1)
        passthrough = dark("c13", 512)
        g.layer("p5", SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        dark("c14", 1024); dark("c15", 512, k=1); dark("c16", 1024)
        dark("c17", 512, k=1); dark("c18", 1024)
        dark("c19", 1024); trunk = dark("c20", 1024)
        # passthrough branch: 64-ch 1x1 then space-to-depth 2x
        g.layer("pt_conv", ConvolutionLayer(n_out=64, kernel_size=(1, 1),
                                            activation="identity"),
                passthrough)
        g.layer("pt_bn", BatchNormalization())
        g.layer("pt_act", ActivationLayer(activation="leakyrelu"))
        g.layer("pt_s2d", SpaceToDepthLayer(block_size=2))
        g.vertex("concat", MergeVertex(), g.last, trunk)
        dark("c21", 1024)
        g.layer("detect_conv",
                ConvolutionLayer(n_out=n_boxes * (5 + self.num_classes),
                                 kernel_size=(1, 1)))
        g.layer("yolo", Yolo2OutputLayer(anchors=_YOLO2_ANCHORS))
        b.set_outputs("yolo")
        return b.build()
