"""Vision transforms: counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py`` (``Compose``, ``Cast``,
``ToTensor``, ``Normalize``, ``RandomResizedCrop``, ``CenterCrop``,
``Resize``, the flips, the colour jitters and ``RandomLighting``).

The images are NDArrays on the CPU. Resizing is the reference's
antialiased linear filter (:func:`mxnet_tpu_torch.image.image.resize_hw`),
and every random draw is ``np.random``'s, as in the reference, so one
``np.random.seed`` gives both packages the same images.
"""
from __future__ import annotations

import numpy as np

import torch

from ....context import cpu
from ....image.image import resize_hw
from ....ndarray.ndarray import NDArray
from ...block import Block, HybridBlock
from ...nn import Sequential


def _array(value, dtype=None):
    """``value`` as an NDArray on the CPU."""
    return NDArray(value, ctx=cpu(), dtype=dtype)

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "RandomResizedCrop",
           "CenterCrop", "Resize", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomColorJitter", "RandomLighting"]


class Compose(Sequential):

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0, 255] to CHW float32 [0, 1]."""

    def hybrid_forward(self, F, x):
        x = F.cast(x, dtype="float32") / 255.0
        if x.ndim == 3:
            return F.transpose(x, axes=(2, 0, 1))
        return F.transpose(x, axes=(0, 3, 1, 2))


class Normalize(HybridBlock):

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def hybrid_forward(self, F, x):
        mean = np.asarray(self._mean, dtype="float32")
        std = np.asarray(self._std, dtype="float32")
        if mean.ndim == 1:
            mean = mean.reshape(-1, 1, 1)
        if std.ndim == 1:
            std = std.reshape(-1, 1, 1)
        return (x - _array(mean)) / _array(std)


def _resize(img_np, size, interp="bilinear"):
    h, w = size if isinstance(size, (list, tuple)) else (size, size)
    if img_np.ndim == 2:
        img_np = img_np[:, :, None]
    img = torch.from_numpy(np.ascontiguousarray(img_np, dtype=np.float32))
    return resize_hw(img, h, w).numpy()


class Resize(Block):

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio

    def forward(self, x):
        img = x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)
        size = self._size
        if isinstance(size, int):
            if self._keep:
                h, w = img.shape[:2]
                if h < w:
                    size = (size, int(w * size / h))
                else:
                    size = (int(h * size / w), size)
            else:
                size = (size, size)
        elif isinstance(size, (list, tuple)) and len(size) == 2:
            size = (size[1], size[0])  # MXNet Resize takes (w, h)
        return _array(_resize(img, size))


class CenterCrop(Block):

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else \
            (size[1], size[0])

    def forward(self, x):
        img = x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)
        h, w = img.shape[:2]
        th, tw = self._size
        if h < th or w < tw:
            img = _resize(img, (max(h, th), max(w, tw)))
            h, w = img.shape[:2]
        y0 = (h - th) // 2
        x0 = (w - tw) // 2
        return _array(img[y0:y0 + th, x0:x0 + tw])


class RandomResizedCrop(Block):

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else \
            (size[1], size[0])
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        img = x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            log_ratio = (np.log(self._ratio[0]), np.log(self._ratio[1]))
            aspect = np.exp(np.random.uniform(*log_ratio))
            nw = int(round(np.sqrt(target_area * aspect)))
            nh = int(round(np.sqrt(target_area / aspect)))
            if nw <= w and nh <= h:
                x0 = np.random.randint(0, w - nw + 1)
                y0 = np.random.randint(0, h - nh + 1)
                crop = img[y0:y0 + nh, x0:x0 + nw]
                return _array(_resize(crop, self._size))
        # fallback: center crop
        return CenterCrop((self._size[1], self._size[0])).forward(
            _array(img))


class RandomFlipLeftRight(Block):

    def forward(self, x):
        if np.random.rand() < 0.5:
            img = x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)
            return _array(np.ascontiguousarray(img[:, ::-1]))
        return x if isinstance(x, NDArray) else _array(x)


class RandomFlipTopBottom(Block):

    def forward(self, x):
        if np.random.rand() < 0.5:
            img = x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)
            return _array(np.ascontiguousarray(img[::-1]))
        return x if isinstance(x, NDArray) else _array(x)


class _RandomJitter(Block):
    def __init__(self, magnitude):
        super().__init__()
        self._m = magnitude

    def _alpha(self):
        return 1.0 + np.random.uniform(-self._m, self._m)


class RandomBrightness(_RandomJitter):

    def forward(self, x):
        img = x.asnumpy().astype("float32") if isinstance(x, NDArray) \
            else np.asarray(x, "float32")
        return _array(np.clip(img * self._alpha(), 0, 255))


class RandomContrast(_RandomJitter):

    def forward(self, x):
        img = x.asnumpy().astype("float32") if isinstance(x, NDArray) \
            else np.asarray(x, "float32")
        alpha = self._alpha()
        gray = img.mean()
        return _array(np.clip(alpha * img + (1 - alpha) * gray, 0, 255))


class RandomSaturation(_RandomJitter):

    def forward(self, x):
        img = x.asnumpy().astype("float32") if isinstance(x, NDArray) \
            else np.asarray(x, "float32")
        alpha = self._alpha()
        gray = img.mean(axis=2, keepdims=True)
        return _array(np.clip(alpha * img + (1 - alpha) * gray, 0, 255))


class RandomColorJitter(Block):

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))

    def forward(self, x):
        order = np.random.permutation(len(self._ts))
        for i in order:
            x = self._ts[i](x)
        return x


class RandomLighting(Block):
    """AlexNet-style PCA noise."""

    _eigval = np.array([55.46, 4.794, 1.148])
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]])

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        img = x.asnumpy().astype("float32") if isinstance(x, NDArray) \
            else np.asarray(x, "float32")
        alpha = np.random.normal(0, self._alpha, 3)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return _array(np.clip(img + rgb, 0, 255))
