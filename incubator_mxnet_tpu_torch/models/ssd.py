"""The SSD object detector (counterpart of
``incubator_mxnet_tpu/models/ssd.py``, MXNet's example/ssd; BASELINE config
4): a downsampling backbone and four detection scales, each with a 3×3
class head and a 3×3 box head, and ``MultiBoxPrior`` anchors per scale.

Its structural parameter names are the JAX package's (``backbone``,
``stage%d``, ``cls%d``, ``loc%d``), so ``convert.from_jax_params`` carries
the JAX model's weights across unchanged. Targets (``MultiBoxTarget``) and
decoding (``MultiBoxDetection``) are ``ops.multibox``'s, outside the
block, as in the reference's training script.
"""
from __future__ import annotations

from .. import ndarray as nd
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ops.multibox import MultiBoxPrior

__all__ = ["SSD"]


def _down_sample(channels):
    blk = nn.HybridSequential()
    for _ in range(2):
        blk.add(nn.Conv2D(channels, 3, padding=1, use_bias=False))
        blk.add(nn.BatchNorm())
        blk.add(nn.Activation("relu"))
    blk.add(nn.MaxPool2D(2, 2))
    return blk


class SSD(HybridBlock):
    """Backbone (two downsamplings) then four scales, the last three each
    after one more downsampling; ``sizes`` and ``ratios`` per scale are
    example/ssd's. At a 512² input and ``base_channels`` 64 the scales
    are 128², 64², 32² and 16², 87,040 anchors in all."""

    def __init__(self, num_classes=20, base_channels=64,
                 sizes=((0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
                        (0.71, 0.79)),
                 ratios=((1, 2, 0.5),) * 4, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.sizes = sizes
        self.ratios = ratios
        self.num_anchors = [len(s) + len(r) - 1 for s, r in zip(sizes, ratios)]
        with self.name_scope():
            self.backbone = nn.HybridSequential(prefix="backbone_")
            for ch in (base_channels, base_channels * 2):
                self.backbone.add(_down_sample(ch))
            self.stages, self.cls_heads, self.loc_heads = [], [], []
            for i in range(4):
                if i > 0:
                    stage = _down_sample(base_channels * 2)
                    self.register_child(stage, "stage%d" % i)
                    self.stages.append(stage)
                cls_head = nn.Conv2D(self.num_anchors[i] * (num_classes + 1),
                                     3, padding=1)
                loc_head = nn.Conv2D(self.num_anchors[i] * 4, 3, padding=1)
                self.register_child(cls_head, "cls%d" % i)
                self.register_child(loc_head, "loc%d" % i)
                self.cls_heads.append(cls_head)
                self.loc_heads.append(loc_head)

    def forward(self, x):
        """(anchors (1, A, 4), class predictions (N, classes + 1, A), box
        predictions (N, A·4))."""
        feat = self.backbone(x)
        anchors, cls_outs, loc_outs = [], [], []
        for i in range(4):
            if i > 0:
                feat = self.stages[i - 1](feat)
            anchors.append(MultiBoxPrior(feat, sizes=self.sizes[i],
                                         ratios=self.ratios[i]))
            c = self.cls_heads[i](feat)          # (N, A_i·(C+1), H, W)
            loc = self.loc_heads[i](feat)
            n = c.shape[0]
            cls_outs.append(c.permute(0, 2, 3, 1).reshape(
                n, -1, self.num_classes + 1))
            loc_outs.append(loc.permute(0, 2, 3, 1).reshape(n, -1))
        return (nd.concat(*anchors, dim=1),
                nd.concat(*cls_outs, dim=1).permute(0, 2, 1),
                nd.concat(*loc_outs, dim=1))
