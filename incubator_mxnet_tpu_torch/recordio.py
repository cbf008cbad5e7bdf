"""RecordIO: MXNet's packed record files and their index (counterpart of
``incubator_mxnet_tpu/recordio.py``).

The files are byte for byte the JAX package's and MXNet's: records framed
as ``[kMagic u32][lrec u32][data][pad to 4B]`` with ``lrec = cflag<<29 |
len``, the image header ``IRHeader = (flag u32, label f32, id u64, id2
u64)``, and a ``.idx`` sidecar of "key\toffset" lines. Images are encoded
and decoded with PIL. The JAX package's native reader waits for the port of
``native/`` (ROADMAP.md §1 item 8).
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as onp

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_kMagic = 0xCED7230A

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential reader/writer."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.record = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if self.is_open:
            self.record.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["record"] = None
        if self.is_open:
            d["_pos"] = self.record.tell()
        return d

    def __setstate__(self, d):
        pos = d.pop("_pos", None)
        self.__dict__.update(d)
        self.open()
        if pos is not None:
            self.record.seek(pos)

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        lrec = len(buf)  # cflag = 0 (single full record)
        self.record.write(struct.pack("<II", _kMagic, lrec))
        self.record.write(buf)
        pad = (4 - (len(buf) & 3)) & 3
        if pad:
            self.record.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        head = self.record.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _kMagic:
            raise IOError("invalid RecordIO magic in %s" % self.uri)
        length = lrec & ((1 << 29) - 1)
        buf = self.record.read(length)
        pad = (4 - (length & 3)) & 3
        if pad:
            self.record.read(pad)
        return buf

    def tell(self):
        return self.record.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random access through the ``.idx`` sidecar."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if not self.writable and os.path.isfile(idx_path):
            with open(idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if getattr(self, "is_open", False) and self.writable:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (k, self.idx[k]))
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        assert self.writable
        key = self.key_type(idx)
        pos = self.record.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """An IRHeader and a payload as one record's bytes."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id, header.id2)
        return hdr + s
    label = onp.asarray(header.label, dtype=onp.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s):
    """(IRHeader, payload) of a record's bytes."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        arr = onp.frombuffer(s[: flag * 4], dtype=onp.float32)
        header = IRHeader(flag, arr, id_, id2)
        s = s[flag * 4:]
    else:
        header = IRHeader(flag, label, id_, id2)
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC image (JPEG or PNG, with PIL) and pack it."""
    import io as _io

    from PIL import Image

    arr = onp.asarray(img).astype("uint8")
    pil = Image.fromarray(arr)
    buf = _io.BytesIO()
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    pil.save(buf, format=fmt, quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1):
    """(IRHeader, HWC numpy image) of a record packed by ``pack_img``."""
    import io as _io

    from PIL import Image

    header, img_bytes = unpack(s)
    pil = Image.open(_io.BytesIO(img_bytes))
    if iscolor == 0:
        pil = pil.convert("L")
    elif iscolor == 1:
        pil = pil.convert("RGB")
    return header, onp.asarray(pil)
