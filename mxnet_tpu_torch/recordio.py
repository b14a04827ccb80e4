"""RecordIO: packed binary record files.

Counterpart of ``mxnet_tpu/recordio.py`` (the reference's
``python/mxnet/recordio.py``: MXRecordIO, MXIndexedRecordIO, IRHeader,
pack/unpack, pack_img/unpack_img), a copy of the same bytes both ways: a
file written by either package reads back in the other byte for byte.

The wire format is dmlc RecordIO: each record is
``[kMagic:u32][cflag|len:u32][payload][pad to 4B]``. Image payloads are
JPEG/PNG (encoded and decoded through PIL, where PIL is installed) or the
raw container (``pack_img(..., img_fmt=".raw")``: a shape header and the
uint8 pixels), which needs nothing but numpy and which the native pump
decodes on any machine.
"""
from __future__ import annotations

import io as _io
import numbers
import os
import struct
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_kMagic = 0xced7230a

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential reader/writer."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.is_open = False
        self.fio = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.fio = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fio = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()
        self.is_open = True

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        del d["fio"]
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        self.fio = None
        is_open = d.get("is_open", False)
        self.is_open = False
        if is_open:
            self.open()

    def _check_pid(self, allow_reset=False):
        if not self.pid == os.getpid():
            if allow_reset:
                self.reset()
            else:
                raise RuntimeError("Forbidden operation in multiple processes")

    def close(self):
        if not self.is_open:
            return
        self.fio.close()
        self.is_open = False
        self.pid = None

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        self._check_pid(allow_reset=False)
        data = struct.pack("<II", _kMagic, len(buf))
        self.fio.write(data)
        self.fio.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.fio.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        self._check_pid(allow_reset=True)
        head = self.fio.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _kMagic:
            raise RuntimeError("Invalid record magic in %s" % self.uri)
        length = lrec & 0x1FFFFFFF
        buf = self.fio.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.fio.read(pad)
        return buf

    def tell(self):
        return self.fio.tell()

    def seek(self, pos):
        self.fio.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access reader/writer with an ``.idx`` file beside it."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.writable:
            self.fidx = open(self.idx_path, "w")
        else:
            self.fidx = open(self.idx_path, "r")
            for line in iter(self.fidx.readline, ""):
                line = line.strip().split("\t")
                key = self.key_type(line[0])
                self.idx[key] = int(line[1])
                self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        super().close()
        if self.fidx is not None:
            self.fidx.close()

    def __getstate__(self):
        d = super().__getstate__()
        del d["fidx"]
        return d

    def seek(self, idx):
        assert not self.writable
        self._check_pid(allow_reset=True)
        pos = self.idx[idx]
        self.fio.seek(pos)

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """Pack a header + payload into one record string (reference
    recordio.py:291)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    s = struct.pack(_IR_FORMAT, *header) + s
    return s


def unpack(s):
    """A record as ``(IRHeader, payload)``."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        header = header._replace(
            label=np.frombuffer(s[:header.flag * 4], np.float32).copy())
        s = s[header.flag * 4:]
    return header, s


_RAW_MAGIC = b"MXTPURAW"


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array (``.jpg`` by default). JPEG/PNG payloads are
    encoded through PIL (without PIL, the raw container); the native pump
    decodes JPEG where it was built with libjpeg (``csrc/io/recordio.cc``).
    ``.raw`` selects the lossless raw container (a shape header and the
    uint8 pixels)."""
    img = np.asarray(img)
    if img_fmt in (".raw", "raw", None):
        shape = np.asarray(img.shape, dtype=np.int32)
        payload = (_RAW_MAGIC + struct.pack("<B", len(shape)) +
                   shape.tobytes() + img.astype(np.uint8).tobytes())
        return pack(header, payload)
    try:
        from PIL import Image
        buf = _io.BytesIO()
        mode = "L" if img.ndim == 2 else "RGB"
        Image.fromarray(img.astype(np.uint8), mode=mode).save(
            buf, format="JPEG" if img_fmt in (".jpg", ".jpeg") else "PNG",
            quality=quality)
        return pack(header, buf.getvalue())
    except ImportError:
        shape = np.asarray(img.shape, dtype=np.int32)
        payload = (_RAW_MAGIC + struct.pack("<B", len(shape)) +
                   shape.tobytes() + img.astype(np.uint8).tobytes())
        return pack(header, payload)


def unpack_img(s, iscolor=-1):
    """A record as ``(IRHeader, HWC uint8 array)``."""
    header, s = unpack(s)
    if s[:8] == _RAW_MAGIC:
        ndim = struct.unpack("<B", s[8:9])[0]
        shape = np.frombuffer(s[9:9 + 4 * ndim], np.int32)
        img = np.frombuffer(s[9 + 4 * ndim:], np.uint8).reshape(shape)
        return header, img
    try:
        from PIL import Image
        img = np.asarray(Image.open(_io.BytesIO(s)))
        return header, img
    except ImportError:
        raise RuntimeError(
            "record payload is a compressed image but PIL is unavailable; "
            "re-pack with recordio.pack_img(..., img_fmt='.raw')")
