"""Image decoding, resizing, crops and augmenters, ``ImageIter`` and the
detection pipeline (counterpart of ``incubator_mxnet_tpu/image.py``).

Decoding is PIL's, as in the JAX package. ``imresize`` is
``torch.nn.functional.interpolate`` matched to the JAX package's
``jax.image.resize``: "bilinear" with half-pixel centres and antialiasing
(a triangle kernel widened by the scale when it shrinks, weights
normalised per output pixel) for ``interp`` > 0, "nearest-exact" for 0; in
float32, cast back to the input's type. The augmenters draw from the same
host generators as the JAX package's (Python's ``random`` for crops and
flips, numpy's for the colour jitters), in the same order, so one seed
gives both packages the same images; their arithmetic runs in torch on the
image's device. Images are HWC NDArrays, on the host from the decoders.
"""
from __future__ import annotations

import io as _io
import os
import random as _random

import numpy as onp
import torch
import torch.nn.functional as F

from . import ndarray as nd
from .context import cpu
from .ndarray import NDArray
from .ndarray.ndarray import _apply

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "color_normalize", "Augmenter",
           "ResizeAug", "RandomCropAug", "CenterCropAug", "HorizontalFlipAug",
           "CastAug", "ColorNormalizeAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "ColorJitterAug",
           "LightingAug", "RandomGrayAug", "CreateAugmenter", "ImageIter"]

# ITU-R BT.601 luma weights — single source for every color augmenter
_LUMA_COEF = onp.array([0.299, 0.587, 0.114], "float32")


def _luma(a):
    return torch.from_numpy(_LUMA_COEF).to(a.device)


def imdecode(buf, flag=1, to_rgb=True, **kwargs):
    """JPEG/PNG bytes as an HWC uint8 NDArray on the host (``flag`` 0:
    one grey channel)."""
    from PIL import Image

    pil = Image.open(_io.BytesIO(bytes(buf)))
    if flag == 0:
        pil = pil.convert("L")
        arr = onp.asarray(pil)[:, :, None]
    else:
        pil = pil.convert("RGB")
        arr = onp.asarray(pil)
    return nd.array(arr, ctx=cpu(), dtype="uint8")


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


def imresize(src, w, h, interp=1):
    """An HWC image resized to (h, w): bilinear with antialiasing (the
    JAX package's ``jax.image.resize`` "linear") for ``interp`` > 0,
    nearest for 0."""
    a = src._data if isinstance(src, NDArray) else \
        torch.from_numpy(onp.ascontiguousarray(src))
    x = a.to(torch.float32).permute(2, 0, 1).unsqueeze(0)
    if interp:
        out = F.interpolate(x, size=(h, w), mode="bilinear",
                            align_corners=False, antialias=True)
    else:
        out = F.interpolate(x, size=(h, w), mode="nearest-exact")
    return NDArray(out[0].permute(1, 2, 0).contiguous().to(a.dtype))


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = _random.randint(0, max(0, w - new_w))
    y0 = _random.randint(0, max(0, h - new_h))
    return fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp), \
        (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max(0, (w - new_w) // 2)
    y0 = max(0, (h - new_h) // 2)
    return fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp), \
        (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = src.astype("float32") - nd.array(mean, ctx=src.context)
    if std is not None:
        src = src / nd.array(std, ctx=src.context)
    return src


class Augmenter:
    """An image transform: ``aug(src)`` gives the new image."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size if isinstance(size, tuple) else (size, size)
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size if isinstance(size, tuple) else (size, size)
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _random.random() < self.p:
            return nd.flip(src, axis=1)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    """Scale by 1 + U(-brightness, brightness)."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + onp.random.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    """Blend with the image's mean luma (no host read)."""

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + onp.random.uniform(-self.contrast, self.contrast)
        src = src if isinstance(src, NDArray) else nd.array(src, ctx=cpu())

        def fn(a):
            gray = torch.sum(a[..., :3] * _luma(a))
            return a * alpha + 3.0 * (1.0 - alpha) / a.numel() * gray

        return _apply(fn, src)


class SaturationJitterAug(Augmenter):
    """Blend with each pixel's luma (no host read)."""

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + onp.random.uniform(-self.saturation, self.saturation)
        src = src if isinstance(src, NDArray) else nd.array(src, ctx=cpu())

        def fn(a):
            gray = torch.sum(a[..., :3] * _luma(a), dim=-1, keepdim=True)
            return a * alpha + gray * (1.0 - alpha)

        return _apply(fn, src)


class ColorJitterAug(Augmenter):
    """Brightness, contrast and saturation jitter in a random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self._augs = []
        if brightness:
            self._augs.append(BrightnessJitterAug(brightness))
        if contrast:
            self._augs.append(ContrastJitterAug(contrast))
        if saturation:
            self._augs.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        for i in onp.random.permutation(len(self._augs)):
            src = self._augs[i](src)
        return src


class LightingAug(Augmenter):
    """AlexNet's PCA lighting noise."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = onp.asarray(eigval, "float32")
        self.eigvec = onp.asarray(eigvec, "float32")

    def __call__(self, src):
        alpha = onp.random.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1).astype("float32")
        return src + nd.array(rgb, ctx=src.context)


class RandomGrayAug(Augmenter):
    """Grey (luma in all three channels) with probability ``p``."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if onp.random.rand() < self.p:
            src = src if isinstance(src, NDArray) else nd.array(src, ctx=cpu())

            def fn(a):
                gray = torch.sum(a[..., :3] * _luma(a), dim=-1, keepdim=True)
                return gray.repeat_interleave(3, dim=-1)

            return _apply(fn, src)
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, rand_gray=0,
                    **kwargs):
    """The standard augmenter list (resize, crop, mirror, cast, colour
    jitter, PCA noise, grey, normalise)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size))
    else:
        auglist.append(CenterCropAug(crop_size))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        eigval = [55.46, 4.794, 1.148]
        eigvec = [[-0.5675, 0.7192, 0.4009],
                  [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]]
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is not None or std is not None:
        if mean is True:
            mean = onp.array([123.68, 116.28, 103.53])
        if std is True:
            std = onp.array([58.395, 57.12, 57.375])
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Image iterator over a ``.rec`` file (through ``ImageRecordIter``), an
    image list file or ``imglist``, with augmenters; batches on the
    host."""

    def __init__(self, batch_size, data_shape, label_width=1, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False, aug_list=None,
                 imglist=None, **kwargs):
        from .io import DataBatch, DataDesc
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._DataBatch = DataBatch
        self.provide_data = [DataDesc("data", (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc("softmax_label", (batch_size,))]
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **kwargs)
        self._items = []
        if path_imgrec:
            from .io import ImageRecordIter
            self._rec_iter = ImageRecordIter(
                path_imgrec=path_imgrec, data_shape=data_shape,
                batch_size=batch_size, shuffle=shuffle, **kwargs)
        else:
            self._rec_iter = None
            if imglist:
                for entry in imglist:
                    self._items.append((float(entry[0]), entry[1]))
            elif path_imglist:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        self._items.append((float(parts[1]),
                                            os.path.join(path_root, parts[-1])))
        self._cursor = 0
        self._shuffle = shuffle

    def reset(self):
        if self._rec_iter is not None:
            self._rec_iter.reset()
        self._cursor = 0
        if self._shuffle:
            _random.shuffle(self._items)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        if self._rec_iter is not None:
            return self._rec_iter.next()
        if self._cursor >= len(self._items):
            raise StopIteration
        datas, labels = [], []
        for _ in range(self.batch_size):
            label, path = self._items[self._cursor % len(self._items)]
            self._cursor += 1
            img = imread(path)
            for aug in self.auglist:
                img = aug(img)
            datas.append(img.transpose((2, 0, 1)).asnumpy())
            labels.append(label)
        return self._DataBatch([nd.array(onp.stack(datas), ctx=cpu())],
                               [nd.array(onp.asarray(labels, "float32"),
                                         ctx=cpu())])


# ---------------------------------------------------------------- detection
# (MXNet's image/detection.py: the box-aware augmenter pipeline)
class DetAugmenter:
    """Base detection augmenter: __call__(src, label) -> (src, label) with
    label (n_obj, 5) = [cls, x1, y1, x2, y2] normalized."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """An image-only Augmenter in the detection pipeline."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """Flip the image and the boxes' x-coordinates with probability p."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if _random.random() < self.p:
            src = nd.flip(src, axis=1)
            label = label.copy()
            x1 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping box centers inside; boxes are clipped and
    re-normalized."""

    def __init__(self, min_crop_scale=0.6, max_attempts=10):
        self.min_scale = min_crop_scale
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        h, w = src.shape[0], src.shape[1]
        for _ in range(self.max_attempts):
            s = self.min_scale + (1 - self.min_scale) * _random.random()
            cw, ch = int(w * s), int(h * s)
            x0 = _random.randint(0, w - cw)
            y0 = _random.randint(0, h - ch)
            nx0, ny0 = x0 / w, y0 / h
            nx1, ny1 = (x0 + cw) / w, (y0 + ch) / h
            cx = (label[:, 1] + label[:, 3]) / 2
            cy = (label[:, 2] + label[:, 4]) / 2
            keep = (cx > nx0) & (cx < nx1) & (cy > ny0) & (cy < ny1)
            if not keep.any():
                continue
            new = label[keep].copy()
            new[:, (1, 3)] = (new[:, (1, 3)] - nx0) / (nx1 - nx0)
            new[:, (2, 4)] = (new[:, (2, 4)] - ny0) / (ny1 - ny0)
            new[:, 1:] = onp.clip(new[:, 1:], 0.0, 1.0)
            return fixed_crop(src, x0, y0, cw, ch), new
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0.0, rand_mirror=False,
                       mean=None, std=None, brightness=0, contrast=0,
                       saturation=0, **kwargs):
    """The standard detection augmenter list."""
    augs = []
    if resize > 0:
        augs.append(DetBorrowAug(ResizeAug(resize)))
    if rand_crop > 0:
        augs.append(DetRandomCropAug())
    if rand_mirror:
        augs.append(DetHorizontalFlipAug(0.5))
    augs.append(DetBorrowAug(ResizeAug(max(data_shape[1], data_shape[2]))))
    augs.append(DetBorrowAug(CenterCropAug((data_shape[2], data_shape[1]))))
    if brightness or contrast or saturation:
        augs.append(DetBorrowAug(ColorJitterAug(brightness, contrast,
                                                saturation)))
    if mean is not None or std is not None:
        augs.append(DetBorrowAug(CastAug()))
        augs.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return augs


class ImageDetIter:
    """Detection iterator over an imglist (items (label (n, 5), path)) or a
    ``.rec`` file; batches carry labels padded to (batch, label_pad, 5)
    with -1 rows."""

    def __init__(self, batch_size, data_shape, imglist=None, path_imgrec=None,
                 label_pad_width=16, shuffle=False, aug_list=None, **kwargs):
        from .io import DataBatch, DataDesc, ImageDetRecordIter
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_pad = label_pad_width
        self._DataBatch = DataBatch
        self.provide_data = [DataDesc("data", (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc("label",
                                       (batch_size, label_pad_width, 5))]
        self.auglist = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape, **kwargs)
        if path_imgrec:
            self._rec = ImageDetRecordIter(
                path_imgrec=path_imgrec, batch_size=batch_size,
                data_shape=data_shape, shuffle=shuffle,
                label_pad_width=label_pad_width, **kwargs)
            self._items = None
        else:
            self._rec = None
            self._items = [(onp.asarray(lbl, "float32").reshape(-1, 5), p)
                           for lbl, p in (imglist or [])]
        self._cursor = 0
        self._shuffle = shuffle

    def reset(self):
        if self._rec is not None:
            self._rec.reset()
        self._cursor = 0
        if self._shuffle and self._items:
            _random.shuffle(self._items)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        if self._rec is not None:
            return self._rec.next()
        if self._cursor >= len(self._items):
            raise StopIteration
        datas, labels = [], []
        for _ in range(self.batch_size):
            label, path = self._items[self._cursor % len(self._items)]
            self._cursor += 1
            img = imread(path)
            for aug in self.auglist:
                img, label = aug(img, label)
            datas.append(img.asnumpy().transpose((2, 0, 1)))
            pad = onp.full((self.label_pad, 5), -1.0, "float32")
            pad[: min(len(label), self.label_pad)] = \
                label[: self.label_pad]
            labels.append(pad)
        return self._DataBatch([nd.array(onp.stack(datas), ctx=cpu())],
                               [nd.array(onp.stack(labels), ctx=cpu())])
