"""Vision datasets and transforms (counterpart of
``incubator_mxnet_tpu/gluon/data/vision.py``).

``MNIST``/``FashionMNIST`` read the idx-gz files and ``CIFAR10``/
``CIFAR100`` the binary batches of a local ``root`` when they are there;
otherwise each makes the JAX package's seeded synthetic stand-in
(``_synthetic``), bit for bit. Nothing is downloaded. Images are HWC uint8
NDArrays on the host, labels int32.

``transforms`` are the JAX package's, with its numpy random calls in the
same order (``numpy.random``'s global generator), so one seed gives both
packages the same flips and crops. They run on the host: numpy inputs
through numpy, NDArrays through ``nd`` on their (host) device. ``Resize``
and ``RandomResizedCrop`` resample with ``jax.image.resize``'s "linear"
arithmetic (a triangle kernel, widened by the scale when shrinking,
weights normalised per output pixel), computed here with numpy and torch.
``ImageRecordDataset`` decodes the images of a RecordIO file and
``ImageFolderDataset`` those of a folder per class, with PIL, as HWC uint8
NDArrays on the host.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as onp
import torch

from ... import ndarray as nd
from ...context import cpu
from ...ndarray import NDArray
from .dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "transforms"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._transform = transform
        self._train = train
        self._root = os.path.expanduser(root)
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)


def _synthetic(n, shape, num_classes, seed):
    """The JAX package's stand-in: class means from their own seeded
    stream (the same for every split), labels and noise keyed by ``n``."""
    base = onp.random.RandomState(seed).rand(num_classes, *shape) \
        .astype("float32")
    rng = onp.random.RandomState(seed + 100003 * n)
    label = rng.randint(0, num_classes, size=(n,)).astype("int32")
    data = base[label] * 0.8 + rng.rand(n, *shape).astype("float32") * 0.2
    return data, label


def _images(data):
    """uint8 images as a host NDArray."""
    return nd.array(data, ctx=cpu(), dtype="uint8")


class MNIST(_DownloadedDataset):
    """MNIST from ``root``'s idx-gz files, else the synthetic stand-in
    (8192 training / 1024 test images of 28 x 28 x 1)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._num_synthetic = 8192 if train else 1024
        super().__init__(root, train, transform)

    def _get_data(self):
        prefix = "train" if self._train else "t10k"
        data_file = os.path.join(self._root, prefix + "-images-idx3-ubyte.gz")
        label_file = os.path.join(self._root, prefix + "-labels-idx1-ubyte.gz")
        if os.path.exists(data_file) and os.path.exists(label_file):
            with gzip.open(label_file, "rb") as fin:
                struct.unpack(">II", fin.read(8))
                label = onp.frombuffer(fin.read(), dtype=onp.uint8) \
                    .astype(onp.int32)
            with gzip.open(data_file, "rb") as fin:
                struct.unpack(">IIII", fin.read(16))
                data = onp.frombuffer(fin.read(), dtype=onp.uint8)
                data = data.reshape(len(label), 28, 28, 1)
        else:
            data, label = _synthetic(self._num_synthetic, (28, 28, 1), 10,
                                     seed=42)
            data = (data * 255).astype("uint8")
        self._data = _images(data)
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from ``root``'s binary batches (``data_batch_{1..5}.bin``,
    ``test_batch.bin``), else the synthetic stand-in (8192 / 1024 images of
    32 x 32 x 3)."""

    _files = (["data_batch_%d.bin" % i for i in range(1, 6)],
              ["test_batch.bin"])
    _label_bytes = 1

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._num_synthetic = 8192 if train else 1024
        self._num_classes = 10
        self._fine_label = False
        super().__init__(root, train, transform)

    def _read_batch(self, path):
        raw = onp.fromfile(path, dtype=onp.uint8)
        raw = raw.reshape(-1, self._label_bytes + 3072)
        label = raw[:, self._label_bytes - 1 if self._fine_label else 0]
        data = raw[:, self._label_bytes:].reshape(-1, 3, 32, 32)
        return data.transpose(0, 2, 3, 1), label.astype(onp.int32)

    def _get_data(self):
        files = [os.path.join(self._root, f)
                 for f in self._files[0 if self._train else 1]]
        if all(os.path.exists(f) for f in files):
            parts = [self._read_batch(f) for f in files]
            data = onp.concatenate([p[0] for p in parts])
            label = onp.concatenate([p[1] for p in parts])
        else:
            data, label = _synthetic(self._num_synthetic, (32, 32, 3),
                                     self._num_classes, seed=1337)
            data = (data * 255).astype("uint8")
        self._data = _images(data)
        self._label = label


class CIFAR100(CIFAR10):
    """CIFAR-100 from ``root``'s ``train.bin``/``test.bin`` (the fine label
    with ``fine_label``, else the coarse one), else the synthetic stand-in
    of 100 classes."""

    _files = (["train.bin"], ["test.bin"])
    _label_bytes = 2

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._num_synthetic = 8192 if train else 1024
        self._num_classes = 100
        self._fine_label = fine_label
        _DownloadedDataset.__init__(self, root, train, transform)


# ---------------------------------------------------------------- resizing
class ImageRecordDataset(Dataset):
    """(image, label) of each record of an image RecordIO file; the image
    decoded with ``flag`` (1 colour, 0 grey) and put through
    ``transform(img, label)`` when given."""

    def __init__(self, filename, flag=1, transform=None):
        from ... import recordio
        self._record = recordio.MXIndexedRecordIO(
            filename[: filename.rfind(".")] + ".idx", filename, "r")
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ... import image, recordio
        record = self._record.read_idx(self._record.keys[idx])
        header, img = recordio.unpack(record)
        img = image.imdecode(img, self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._record.keys)


class ImageFolderDataset(Dataset):
    """(image, label) of the images in ``root/<class>/``, the labels from
    the sorted class folder names (``synsets``)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    self.items.append((os.path.join(path, fname), label))

    def __getitem__(self, idx):
        from ... import image
        img = image.imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


def _resize_weights(in_size, out_size):
    """``jax.image.resize``'s "linear" weights (``compute_weight_mat``) as
    an (in_size, out_size) float32 matrix: a triangle kernel at the
    half-pixel sample positions, widened by 1/scale when shrinking,
    normalised per output pixel, zero outside the input."""
    f32 = onp.float32
    scale = f32(out_size) / f32(in_size)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (onp.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.5)
    x = onp.abs(sample_f[None, :] - onp.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    weights = onp.maximum(f32(0), f32(1) - onp.abs(x)).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    eps = 1000.0 * float(onp.finfo(onp.float32).eps)
    weights = onp.where(onp.abs(total) > eps,
                        weights / onp.where(total != 0, total, f32(1)),
                        f32(0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return onp.where(inside[None, :], weights, f32(0)).astype(f32)


def _resize_hwc(a, h, w):
    """An HWC image resized to (h, w) in float32, each changed axis
    contracted in turn (height, then width), cast back to its dtype."""
    dtype = a.dtype
    out = torch.from_numpy(onp.ascontiguousarray(a).astype(onp.float32))
    if out.shape[0] != h:
        wt = torch.from_numpy(_resize_weights(out.shape[0], h))
        out = torch.einsum("hwc,ho->owc", out, wt)
    if out.shape[1] != w:
        wt = torch.from_numpy(_resize_weights(out.shape[1], w))
        out = torch.einsum("hwc,wo->hoc", out, wt)
    return out.numpy().astype(dtype)


def _host(x):
    return x.asnumpy() if isinstance(x, NDArray) else onp.asarray(x)


def _to_nd_img(x):
    return x if isinstance(x, NDArray) else nd.array(onp.asarray(x),
                                                     ctx=cpu())


def _out(out, args):
    return (out,) + args if args else out


class transforms:
    """The JAX package's ``gluon.data.vision.transforms``: callables of an
    HWC image (and any further fields, passed through)."""

    class Compose:
        def __init__(self, transforms_list):
            self._ts = transforms_list

        def __call__(self, x, *args):
            for t in self._ts:
                x = t(x)
            return _out(x, args)

    class ToTensor:
        """HWC uint8 -> CHW float32 in [0, 1]. A numpy image goes through
        torch in one widening copy and one division in place, whose
        kernels release the GIL (the loader's threads run in parallel);
        the values are the JAX package's numpy ones, bit for bit."""

        def __call__(self, x, *args):
            if isinstance(x, NDArray):
                out = x.astype("float32").transpose((2, 0, 1)) / 255.0
            else:
                t = torch.from_numpy(onp.ascontiguousarray(x))
                t = t.permute(2, 0, 1).to(
                    torch.float32, memory_format=torch.contiguous_format)
                out = NDArray(t.div_(255.0))
            return _out(out, args)

    class Normalize:
        """``(x - mean) / std`` per channel of a CHW image (the division
        in place on the difference)."""

        def __init__(self, mean=0.0, std=1.0):
            self._mean = torch.from_numpy(onp.asarray(
                mean, dtype="float32").reshape(-1, 1, 1))
            self._std = torch.from_numpy(onp.asarray(
                std, dtype="float32").reshape(-1, 1, 1))

        def __call__(self, x, *args):
            t = x._data if isinstance(x, NDArray) else torch.as_tensor(x)
            out = torch.sub(t, self._mean.to(t.device))
            out = NDArray(out.div_(self._std.to(t.device)))
            return _out(out, args)

    class Cast:
        def __init__(self, dtype="float32"):
            self._dtype = dtype

        def __call__(self, x, *args):
            return _out(x.astype(self._dtype), args)

    class Resize:
        """To ``size`` (w, h), or a square; bilinear only, without
        ``keep_ratio``, as the JAX package resizes."""

        def __init__(self, size, keep_ratio=False, interpolation=1):
            if keep_ratio or interpolation != 1:
                raise NotImplementedError(
                    "Resize resamples bilinearly to the given size; "
                    "keep_ratio and other interpolations are not ported")
            self._size = (size, size) if isinstance(size, int) \
                else tuple(size)

        def __call__(self, x, *args):
            out = nd.array(_resize_hwc(_host(x), self._size[1],
                                       self._size[0]), ctx=cpu())
            return _out(out, args)

    class RandomFlipLeftRight:
        def __call__(self, x, *args):
            if onp.random.rand() < 0.5:
                x = nd.flip(x, 1) if isinstance(x, NDArray) else x[:, ::-1, :]
            return _out(x, args)

    class RandomFlipTopBottom:
        def __call__(self, x, *args):
            if onp.random.rand() < 0.5:
                x = nd.flip(x, 0) if isinstance(x, NDArray) else x[::-1, :, :]
            return _out(x, args)

    class CenterCrop:
        """The centred (w, h) window, zero-padded when the image is
        smaller."""

        def __init__(self, size):
            self._size = (size, size) if isinstance(size, int) \
                else tuple(size)

        def __call__(self, x, *args):
            a = _host(x)
            tw, th = self._size
            h, w = a.shape[:2]
            y0 = max(0, (h - th) // 2)
            x0 = max(0, (w - tw) // 2)
            out = a[y0:y0 + th, x0:x0 + tw]
            if out.shape[0] < th or out.shape[1] < tw:
                pad = onp.zeros((th, tw) + a.shape[2:], a.dtype)
                pad[:out.shape[0], :out.shape[1]] = out
                out = pad
            return _out(nd.array(out, ctx=cpu()), args)

    class RandomCrop:
        """A random (w, h) window after zero-padding by ``pad``."""

        def __init__(self, size, pad=0):
            self._size = (size, size) if isinstance(size, int) \
                else tuple(size)
            self._pad = pad

        def __call__(self, x, *args):
            a = _host(x)
            if self._pad:
                p = self._pad
                a = onp.pad(a, ((p, p), (p, p), (0, 0)))
            tw, th = self._size
            h, w = a.shape[:2]
            y0 = onp.random.randint(0, max(1, h - th + 1))
            x0 = onp.random.randint(0, max(1, w - tw + 1))
            return _out(nd.array(a[y0:y0 + th, x0:x0 + tw], ctx=cpu()),
                        args)

    class RandomResizedCrop:
        """A crop of random area and aspect ratio (10 tries), resized to
        ``size``."""

        def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
            self._size = (size, size) if isinstance(size, int) \
                else tuple(size)
            self._scale = scale
            self._ratio = ratio

        def __call__(self, x, *args):
            a = _host(x)
            h, w = a.shape[:2]
            for _ in range(10):
                area = h * w * onp.random.uniform(*self._scale)
                ar = onp.random.uniform(*self._ratio)
                cw = int(round(onp.sqrt(area * ar)))
                ch = int(round(onp.sqrt(area / ar)))
                if cw <= w and ch <= h:
                    y0 = onp.random.randint(0, h - ch + 1)
                    x0 = onp.random.randint(0, w - cw + 1)
                    a = a[y0:y0 + ch, x0:x0 + cw]
                    break
            tw, th = self._size
            return _out(nd.array(_resize_hwc(a, th, tw), ctx=cpu()), args)

    class RandomBrightness:
        def __init__(self, brightness):
            self._b = brightness

        def __call__(self, x, *args):
            f = 1.0 + onp.random.uniform(-self._b, self._b)
            return _out(x * f, args)

    class RandomContrast:
        def __init__(self, contrast):
            self._c = contrast

        def __call__(self, x, *args):
            f = 1.0 + onp.random.uniform(-self._c, self._c)
            img = _to_nd_img(x)
            mean = float(nd.mean(img).asnumpy())
            return _out(img * f + mean * (1.0 - f), args)

    class RandomSaturation:
        def __init__(self, saturation):
            self._s = saturation

        def __call__(self, x, *args):
            f = 1.0 + onp.random.uniform(-self._s, self._s)
            img = _to_nd_img(x)
            gray = nd.mean(img, axis=-1, keepdims=True)
            return _out(img * f + gray * (1.0 - f), args)

    class RandomColorJitter:
        """Brightness, contrast and saturation jitter in a random order
        (the JAX package takes ``hue`` and ignores it; here it raises)."""

        def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
            if hue:
                raise NotImplementedError("hue jitter is not ported")
            self._ts = []
            if brightness:
                self._ts.append(transforms.RandomBrightness(brightness))
            if contrast:
                self._ts.append(transforms.RandomContrast(contrast))
            if saturation:
                self._ts.append(transforms.RandomSaturation(saturation))

        def __call__(self, x, *args):
            order = onp.random.permutation(len(self._ts)) if self._ts else []
            for i in order:
                x = self._ts[i](x)
            return _out(x, args)
