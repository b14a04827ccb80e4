"""Image loading, transforms, the augmenters and ImageIter.

Counterpart of ``mxnet_tpu/image/image.py`` (the reference's
``python/mxnet/image/image.py``): ``imread``/``imdecode``/``imresize``, the
crops, ``color_normalize``, every ``Augmenter``, ``CreateAugmenter`` and
``ImageIter`` over ``.rec`` and ``.lst`` files. Decoding goes through PIL
where it is installed, and the raw record container needs only numpy.
Images and batches are NDArrays on the CPU.

``imresize`` is the reference's ``jax.image.resize(method="linear")``: a
separable triangle filter that widens with the scale when it shrinks an
image (antialiasing); ``F.interpolate(mode="bilinear", antialias=True,
align_corners=False)`` is that filter. On uint8-valued images it agrees
with the reference within 5e-4 (2e-6 of the [0, 255] range: float32
sums taken in another order; a scale-and-translate written out with the
reference's own weight matrices came no closer). An integer image is rounded half to even, then
clipped to [0, 255], as the reference rounds it. The random draws are the
reference's (``random`` for the crops and flips, ``np.random`` for the
lighting noise), so one seed gives both packages the same images.
"""
from __future__ import annotations

import os
import random as pyrandom

import numpy as np

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..context import cpu
from ..io.io import DataIter, DataBatch, DataDesc
from ..ndarray.ndarray import NDArray


def _array(value, dtype=None):
    """``value`` as an NDArray on the CPU."""
    return NDArray(value, ctx=cpu(), dtype=dtype)

__all__ = ["imread", "imdecode", "imresize", "ImageIter", "CreateAugmenter"]


def _to_np(img):
    return img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)


def imread(filename, flag=1, to_rgb=True):
    """An image file (or a ``.npy`` array) as an HWC NDArray."""
    if filename.endswith(".npy"):
        return _array(np.load(filename))
    try:
        from PIL import Image
    except ImportError:
        raise MXNetError("imread needs PIL for %s (or use .npy files)"
                         % filename)
    img = Image.open(filename)
    if flag == 0:
        img = img.convert("L")
    else:
        img = img.convert("RGB")
    return _array(np.asarray(img))


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Image bytes (JPEG/PNG through PIL, or the raw container) as an
    HWC NDArray."""
    import io as _io
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    try:
        from PIL import Image
        img = Image.open(_io.BytesIO(bytes(buf)))
        img = img.convert("L" if flag == 0 else "RGB")
        return _array(np.asarray(img))
    except ImportError:
        from ..recordio import _RAW_MAGIC
        import struct
        if bytes(buf[:8]) == _RAW_MAGIC:
            ndim = struct.unpack("<B", bytes(buf[8:9]))[0]
            shape = np.frombuffer(bytes(buf[9:9 + 4 * ndim]), np.int32)
            return _array(np.frombuffer(
                bytes(buf[9 + 4 * ndim:]), np.uint8).reshape(shape))
        raise MXNetError("imdecode needs PIL for compressed images")


def resize_hw(img, h, w):
    """An ``(H, W, ...)`` float32 tensor resized to ``(h, w, ...)`` with
    the antialiased triangle filter (``jax.image.resize(method=
    "linear")``)."""
    shape = tuple(img.shape)
    x = img.reshape(shape[0], shape[1], -1).permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).reshape((h, w) + shape[2:])


def imresize(src, w, h, interp=1):
    """``src`` (HWC) resized to ``(h, w)`` on its own device; integer
    images are rounded half to even and clipped to [0, 255]."""
    v = src._data if isinstance(src, NDArray) else \
        torch.from_numpy(np.ascontiguousarray(_to_np(src)))
    dt = v.dtype
    out = resize_hw(v.float(), h, w)
    if not dt.is_floating_point:
        out = torch.round(out).clamp(0, 255)
    return NDArray(out.to(dt))


def resize_short(src, size, interp=2):
    h, w = _to_np(src).shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = _array(_to_np(src)[y0:y0 + h, x0:x0 + w])
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    img = _to_np(src)
    h, w = img.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    img = _to_np(src)
    h, w = img.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2, **kwargs):
    img = _to_np(src)
    h, w = img.shape[:2]
    src_area = h * w
    if isinstance(area, (float, int)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = pyrandom.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def scale_down(src_size, size):
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def color_normalize(src, mean, std=None):
    src = src.astype("float32") if isinstance(src, NDArray) else \
        _array(_to_np(src).astype("float32"))
    out = src - (mean if isinstance(mean, NDArray) else _array(np.asarray(mean)))
    if std is not None:
        out = out / (std if isinstance(std, NDArray) else _array(np.asarray(std)))
    return out


def copyMakeBorder(src, top, bot, left, right, *args, **kwargs):
    img = _to_np(src)
    pad = [(top, bot), (left, right)] + [(0, 0)] * (img.ndim - 2)
    return _array(np.pad(img, pad, mode="constant"))


class Augmenter:
    """Base of the augmenters: ``__call__(src)`` returns the augmented
    image."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2, **kwargs):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return _array(np.ascontiguousarray(_to_np(src)[:, ::-1]))
        return src


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return _array(_to_np(src).astype("float32") * alpha)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        img = _to_np(src).astype("float32")
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        gray = img.mean()
        return _array(alpha * img + (1 - alpha) * gray)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        img = _to_np(src).astype("float32")
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        gray = img.mean(axis=2, keepdims=True)
        return _array(alpha * img + (1 - alpha) * gray)


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval)
        self.eigvec = np.asarray(eigvec)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return _array(_to_np(src).astype("float32") + rgb)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = np.asarray(mean) if mean is not None else None
        self.std = np.asarray(std) if std is not None else None

    def __call__(self, src):
        img = _to_np(src).astype("float32")
        if self.mean is not None:
            img = img - self.mean
        if self.std is not None:
            img = img / self.std
        return _array(img)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """The reference's default augmenter list for ``data_shape``."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """Pure-Python image iterator over a ``.rec`` file or a ``.lst`` list
    of images."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, dtype="float32", **kwargs):
        super().__init__(batch_size)
        assert path_imgrec or path_imglist or imglist is not None
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self.label_width = label_width
        self.shuffle = shuffle
        self.dtype = dtype
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **{k: v for k, v in kwargs.items()
                                           if k in ("resize", "rand_crop",
                                                    "rand_resize",
                                                    "rand_mirror", "mean",
                                                    "std")})
        self.imgrec = None
        self.imglist = None
        if path_imgrec:
            from ..recordio import MXIndexedRecordIO, MXRecordIO
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx_path):
                self.imgrec = MXIndexedRecordIO(idx_path, path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                rec = MXRecordIO(path_imgrec, "r")
                self._records = []
                while True:
                    r = rec.read()
                    if r is None:
                        break
                    self._records.append(r)
                self.seq = list(range(len(self._records)))
        else:
            if path_imglist:
                with open(path_imglist) as f:
                    imglist = {}
                    for line in f:
                        parts = line.strip().split("\t")
                        imglist[int(parts[0])] = (
                            np.array([float(x) for x in parts[1:-1]]),
                            parts[-1])
            self.imglist = imglist
            self.path_root = path_root
            self.seq = list(imglist.keys())
        # sharding across workers (part_index/num_parts)
        n = len(self.seq)
        per = n // num_parts
        self.seq = self.seq[part_index * per:
                            (part_index + 1) * per if part_index <
                            num_parts - 1 else n]
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        if self.shuffle:
            pyrandom.shuffle(self.seq)
        self.cur = 0

    def next_sample(self):
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.imgrec is not None:
            from ..recordio import unpack
            header, img = unpack(self.imgrec.read_idx(idx))
            return header.label, imdecode(img)
        if hasattr(self, "_records"):
            from ..recordio import unpack
            header, img = unpack(self._records[idx])
            return header.label, imdecode(img)
        label, fname = self.imglist[idx]
        return label, imread(os.path.join(self.path_root, fname))

    def next(self):
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, c, h, w), self.dtype)
        batch_label = np.zeros((self.batch_size, self.label_width),
                               self.dtype)
        i = 0
        while i < self.batch_size:
            label, img = self.next_sample()
            for aug in self.auglist:
                img = aug(img)
            arr = _to_np(img)
            if arr.ndim == 2:
                arr = np.stack([arr] * c, axis=2)
            batch_data[i] = arr.transpose(2, 0, 1)[:c]
            batch_label[i] = label if np.ndim(label) else [label]
            i += 1
        label_out = batch_label[:, 0] if self.label_width == 1 \
            else batch_label
        return DataBatch(data=[_array(batch_data)],
                         label=[_array(label_out)], pad=0)
