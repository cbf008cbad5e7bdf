"""Vision model zoo (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision.py``): ResNet v1 and v2 (18 to
152 layers), VGG 11/13/16/19 with and without batch norm, AlexNet,
DenseNet 121/161/169/201, SqueezeNet 1.0/1.1, MobileNet 1.0/0.75/0.5/0.25,
MobileNet v2 1.0 and Inception v3, each by its ``get_model`` name.
Convolutions and pooling run on PyTorch's library route (cuDNN on the
card), as the JAX package leaves them to XLA; they do not go through
``ops.conv_bwd``. Pretrained weights are not available: ``pretrained=True``
raises, and nothing is downloaded.
"""
from __future__ import annotations

from ... import ndarray as nd
from .. import nn
from ..block import HybridBlock

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2", "VGG", "get_vgg", "vgg11",
           "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn",
           "vgg19_bn", "AlexNet", "alexnet", "DenseNet", "get_densenet",
           "densenet121", "densenet161", "densenet169", "densenet201",
           "SqueezeNet", "squeezenet1_0", "squeezenet1_1", "MobileNet",
           "MobileNetV2", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
           "mobilenet0_25", "mobilenet_v2_1_0", "Inception3",
           "inception_v3", "get_model"]


def _no_pretrained(pretrained):
    if pretrained:
        raise RuntimeError("pretrained weights unavailable offline; "
                           "load the parameters from a local file instead")


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels, 3, stride, 1, use_bias=False,
                                in_channels=in_channels))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, 3, 1, 1, use_bias=False))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, 1, stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return nd.Activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, 1, stride, use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels // 4, 3, 1, 1, use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, 1, 1, use_bias=False))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, 1, stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return nd.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels, 3, stride, 1, use_bias=False,
                               in_channels=in_channels)
        self.bn2 = nn.BatchNorm()
        self.conv2 = nn.Conv2D(channels, 3, 1, 1, use_bias=False,
                               in_channels=channels)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.bn1(x)
        x = nd.Activation(x, act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = nd.Activation(x, act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels // 4, 1, 1, use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = nn.Conv2D(channels // 4, 3, stride, 1, use_bias=False)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, 1, 1, use_bias=False)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.bn1(x)
        x = nd.Activation(x, act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = nd.Activation(x, act_type="relu")
        x = self.conv2(x)
        x = self.bn3(x)
        x = nd.Activation(x, act_type="relu")
        x = self.conv3(x)
        return x + residual


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("ResNet needs one more channel count than "
                             "stages, got %d and %d"
                             % (len(channels), len(layers)))
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(nn.Conv2D(channels[0], 3, 1, 1,
                                            use_bias=False))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0):
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                prefix=""))
        return layer

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("ResNet needs one more channel count than "
                             "stages, got %d and %d"
                             % (len(channels), len(layers)))
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(nn.Conv2D(channels[0], 3, 1, 1,
                                            use_bias=False))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=in_channels))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    _make_layer = ResNetV1._make_layer

    def forward(self, x):
        return self.output(self.features(x))


_resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, classes=1000,
               **kwargs):
    """ResNet v``version`` (1 or 2) of ``num_layers`` (18, 34, 50, 101 or
    152) layers."""
    _no_pretrained(pretrained)
    block_type, layers, channels = _resnet_spec[num_layers]
    resnet_class = [ResNetV1, ResNetV2][version - 1]
    block_class = _resnet_block_versions[version - 1][block_type]
    return resnet_class(block_class, layers, channels, classes=classes,
                        **kwargs)


def resnet18_v1(**kw): return get_resnet(1, 18, **kw)      # noqa: E704
def resnet34_v1(**kw): return get_resnet(1, 34, **kw)      # noqa: E704
def resnet50_v1(**kw): return get_resnet(1, 50, **kw)      # noqa: E704
def resnet101_v1(**kw): return get_resnet(1, 101, **kw)    # noqa: E704
def resnet152_v1(**kw): return get_resnet(1, 152, **kw)    # noqa: E704
def resnet18_v2(**kw): return get_resnet(2, 18, **kw)      # noqa: E704
def resnet34_v2(**kw): return get_resnet(2, 34, **kw)      # noqa: E704
def resnet50_v2(**kw): return get_resnet(2, 50, **kw)      # noqa: E704
def resnet101_v2(**kw): return get_resnet(2, 101, **kw)    # noqa: E704
def resnet152_v2(**kw): return get_resnet(2, 152, **kw)    # noqa: E704


# ------------------------------------------------------------------ VGG
class VGG(HybridBlock):
    """VGG (Simonyan & Zisserman, 2014), with or without batch norm."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes)

    def _make_features(self, layers, filters, batch_norm):
        featurizer = nn.HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3, padding=1))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def forward(self, x):
        x = self.features(x)
        return self.output(x)


_vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
             13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
             16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
             19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    layers, filters = _vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kw): return get_vgg(11, **kw)  # noqa: E704
def vgg13(**kw): return get_vgg(13, **kw)  # noqa: E704
def vgg16(**kw): return get_vgg(16, **kw)  # noqa: E704
def vgg19(**kw): return get_vgg(19, **kw)  # noqa: E704
def vgg11_bn(**kw): return get_vgg(11, batch_norm=True, **kw)  # noqa: E704
def vgg13_bn(**kw): return get_vgg(13, batch_norm=True, **kw)  # noqa: E704
def vgg16_bn(**kw): return get_vgg(16, batch_norm=True, **kw)  # noqa: E704
def vgg19_bn(**kw): return get_vgg(19, batch_norm=True, **kw)  # noqa: E704


# ------------------------------------------------------------------ AlexNet
class AlexNet(HybridBlock):
    """AlexNet (Krizhevsky et al., 2012)."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(64, 11, 4, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Conv2D(192, 5, padding=2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Conv2D(384, 3, padding=1, activation="relu"))
            self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
            self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def forward(self, x):
        x = self.features(x)
        return self.output(x)


def alexnet(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return AlexNet(**kwargs)


# ------------------------------------------------------------------ DenseNet
class _DenseBlock(HybridBlock):
    def __init__(self, num_layers, bn_size, growth_rate, dropout, **kwargs):
        super().__init__(**kwargs)
        self.blocks = []
        for i in range(num_layers):
            blk = nn.HybridSequential(prefix="")
            blk.add(nn.BatchNorm())
            blk.add(nn.Activation("relu"))
            blk.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1,
                              use_bias=False))
            blk.add(nn.BatchNorm())
            blk.add(nn.Activation("relu"))
            blk.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                              use_bias=False))
            if dropout:
                blk.add(nn.Dropout(dropout))
            self.register_child(blk, "b%d" % i)
            self.blocks.append(blk)

    def forward(self, x):
        for blk in self.blocks:
            out = blk(x)
            x = nd.concat(x, out, dim=1)
        return x


def _make_transition(num_output_features):
    out = nn.HybridSequential(prefix="")
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(nn.AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    """DenseNet (Huang et al., 2017)."""

    def __init__(self, num_init_features, growth_rate, block_config, bn_size=4,
                 dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                        strides=2, padding=3,
                                        use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_DenseBlock(num_layers, bn_size,
                                              growth_rate, dropout))
                num_features = num_features + num_layers * growth_rate
                if i != len(block_config) - 1:
                    num_features = num_features // 2
                    self.features.add(_make_transition(num_features))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.AvgPool2D(pool_size=7))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def forward(self, x):
        x = self.features(x)
        return self.output(x)


_densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                  161: (96, 48, [6, 12, 36, 24]),
                  169: (64, 32, [6, 12, 32, 32]),
                  201: (64, 32, [6, 12, 48, 32])}


def get_densenet(num_layers, pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    num_init_features, growth_rate, block_config = _densenet_spec[num_layers]
    return DenseNet(num_init_features, growth_rate, block_config, **kwargs)


def densenet121(**kw): return get_densenet(121, **kw)  # noqa: E704
def densenet161(**kw): return get_densenet(161, **kw)  # noqa: E704
def densenet169(**kw): return get_densenet(169, **kw)  # noqa: E704
def densenet201(**kw): return get_densenet(201, **kw)  # noqa: E704


# ------------------------------------------------------------------ SqueezeNet
class _Fire(HybridBlock):
    def __init__(self, squeeze_channels, expand1x1_channels,
                 expand3x3_channels, **kw):
        super().__init__(**kw)
        self.squeeze = nn.Conv2D(squeeze_channels, kernel_size=1,
                                 activation="relu")
        self.expand1x1 = nn.Conv2D(expand1x1_channels, kernel_size=1,
                                   activation="relu")
        self.expand3x3 = nn.Conv2D(expand3x3_channels, kernel_size=3,
                                   padding=1, activation="relu")

    def forward(self, x):
        x = self.squeeze(x)
        return nd.concat(self.expand1x1(x), self.expand3x3(x), dim=1)


class SqueezeNet(HybridBlock):
    """SqueezeNet 1.0 or 1.1 (Iandola et al., 2016)."""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        assert version in ("1.0", "1.1")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(64, 256, 256))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(64, 256, 256))
                self.features.add(_Fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1,
                                      activation="relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def forward(self, x):
        x = self.features(x)
        return self.output(x)


def squeezenet1_0(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return SqueezeNet("1.1", **kw)


# ------------------------------------------------------------------ MobileNet
def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm(scale=True))
    if active:
        out.add(nn.HybridLambda(
            lambda x: nd.clip(x, 0, 6) if relu6 else nd.relu(x)))


class MobileNet(HybridBlock):
    """MobileNet v1 (Howard et al., 2017): depthwise-separable convs."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _add_conv(self.features, int(32 * multiplier), 3, 2, 1)
            dw_channels = [int(x * multiplier) for x in
                           [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                           + [1024]]
            channels = [int(x * multiplier) for x in
                        [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
            strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
            for dwc, c, s in zip(dw_channels, channels, strides):
                # depthwise, then pointwise
                _add_conv(self.features, dwc, 3, s, 1, num_group=dwc)
                _add_conv(self.features, c, 1, 1, 0)
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def forward(self, x):
        x = self.features(x)
        return self.output(x)


class _LinearBottleneck(HybridBlock):
    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        self.out = nn.HybridSequential()
        _add_conv(self.out, in_channels * t, relu6=True)
        _add_conv(self.out, in_channels * t, 3, stride, 1,
                  num_group=in_channels * t, relu6=True)
        _add_conv(self.out, channels, active=False)

    def forward(self, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNetV2(HybridBlock):
    """MobileNet v2 (Sandler et al., 2018): inverted residuals."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="features_")
            _add_conv(self.features, int(32 * multiplier), 3, 2, 1, relu6=True)
            in_channels_group = [int(x * multiplier) for x in
                                 [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4 +
                                 [96] * 3 + [160] * 3]
            channels_group = [int(x * multiplier) for x in
                              [16] + [24] * 2 + [32] * 3 + [64] * 4
                              + [96] * 3 + [160] * 3 + [320]]
            ts = [1] + [6] * 16
            strides = [1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1]
            for in_c, c, t, s in zip(in_channels_group, channels_group, ts,
                                     strides):
                self.features.add(_LinearBottleneck(in_c, c, t, s))
            last_channels = int(1280 * multiplier) if multiplier > 1.0 \
                else 1280
            _add_conv(self.features, last_channels, relu6=True)
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.HybridSequential(prefix="output_")
            self.output.add(nn.Conv2D(classes, 1, use_bias=False,
                                      prefix="pred_"))
            self.output.add(nn.Flatten())

    def forward(self, x):
        x = self.features(x)
        return self.output(x)


def mobilenet1_0(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return MobileNet(1.0, **kw)


def mobilenet0_75(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return MobileNet(0.75, **kw)


def mobilenet0_5(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return MobileNet(0.5, **kw)


def mobilenet0_25(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return MobileNet(0.25, **kw)


def mobilenet_v2_1_0(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return MobileNetV2(1.0, **kw)


# ------------------------------------------------------------- Inception v3
def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {}
        for i, value in enumerate(setting):
            if value is not None:
                kwargs[setting_names[i]] = value
        out.add(_make_basic_conv(**kwargs))
    return out


class _Concurrent(HybridBlock):
    """Run children on same input, concat on channel axis."""

    def add(self, block):
        self.register_child(block)

    def forward(self, x):
        return nd.concat(*[blk(x) for blk in self._modules.values()], dim=1)


def _make_A(pool_features, prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (64, 1, None, None)))
    out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, None, 1)))
    out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (384, 3, 2, None)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (192, 1, None, None)))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0))))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (192, (1, 7), None, (0, 3))))
    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
    out.add(_make_branch(None, (192, 1, None, None),
                         (192, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0)), (192, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


class _SplitConcat(HybridBlock):
    def __init__(self, first, b1, b2, **kw):
        super().__init__(**kw)
        self.first = first
        self.b1 = b1
        self.b2 = b2

    def forward(self, x):
        x = self.first(x)
        return nd.concat(self.b1(x), self.b2(x), dim=1)


def _make_E(prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (320, 1, None, None)))
    out.add(_SplitConcat(_make_basic_conv(channels=384, kernel_size=1),
                         _make_basic_conv(channels=384, kernel_size=(1, 3),
                                          padding=(0, 1)),
                         _make_basic_conv(channels=384, kernel_size=(3, 1),
                                          padding=(1, 0))))
    out.add(_SplitConcat(
        _seq(_make_basic_conv(channels=448, kernel_size=1),
             _make_basic_conv(channels=384, kernel_size=3, padding=1)),
        _make_basic_conv(channels=384, kernel_size=(1, 3), padding=(0, 1)),
        _make_basic_conv(channels=384, kernel_size=(3, 1), padding=(1, 0))))
    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _seq(*blocks):
    s = nn.HybridSequential(prefix="")
    for b in blocks:
        s.add(b)
    return s


class Inception3(HybridBlock):
    """Inception v3 (Szegedy et al., 2015), at 299x299 input."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_make_E("E1_"))
            self.features.add(_make_E("E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def forward(self, x):
        x = self.features(x)
        return self.output(x)


def inception_v3(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return Inception3(**kw)


_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2, "vgg11": vgg11,
    "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19, "vgg11_bn": vgg11_bn,
    "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn, "vgg19_bn": vgg19_bn,
    "alexnet": alexnet, "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "inceptionv3": inception_v3,
}


def get_model(name, **kwargs):
    """The model zoo's model ``name`` (``_models``' keys, MXNet's names)."""
    name = name.lower()
    if name not in _models:
        raise ValueError("Model %s not supported. Available: %s"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
