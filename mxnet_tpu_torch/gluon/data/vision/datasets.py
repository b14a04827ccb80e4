"""Vision datasets: counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py`` (MNIST, FashionMNIST, CIFAR10,
CIFAR100, ImageRecordDataset, ImageFolderDataset).

Nothing is downloaded: each dataset reads the standard files under
``root`` when they are there, and otherwise the reference's deterministic
synthetic data of the same shapes and dtypes (with a warning;
``synthetic=False`` raises instead). Images are NDArrays on the CPU.
"""
from __future__ import annotations

import gzip
import os
import struct
import warnings

import numpy as np

from .. import dataset
from ....context import cpu
from ....ndarray.ndarray import NDArray


def _array(value, dtype=None):
    """``value`` as an NDArray on the CPU."""
    return NDArray(value, ctx=cpu(), dtype=dtype)

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(dataset.Dataset):
    def __init__(self, root, transform):
        super().__init__()
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _synthetic(shape, num_classes, n, seed):
    rng = np.random.RandomState(seed)
    data = (rng.rand(n, *shape) * 255).astype(np.uint8)
    label = rng.randint(0, num_classes, n).astype(np.int32)
    return data, label


class MNIST(_DownloadedDataset):
    """The standard idx files under ``root``, else deterministic synthetic
    data with a warning."""

    _train_files = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
    _test_files = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")
    _shape = (28, 28, 1)
    _classes = 10
    _synthetic_n = 2048

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None, synthetic=None):
        self._train = train
        self._synthetic = synthetic
        super().__init__(root, transform)

    def _read_idx(self, path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            _, _, dims = struct.unpack(">HBB", f.read(4))
            shape = tuple(struct.unpack(">I", f.read(4))[0]
                          for _ in range(dims))
            return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        img_path = os.path.join(self._root, files[0])
        lbl_path = os.path.join(self._root, files[1])
        for p in (img_path, lbl_path):
            if not os.path.exists(p) and os.path.exists(p[:-3]):
                p_raw = p[:-3]
        if os.path.exists(img_path) or os.path.exists(img_path[:-3]):
            img = self._read_idx(img_path if os.path.exists(img_path)
                                 else img_path[:-3])
            lbl = self._read_idx(lbl_path if os.path.exists(lbl_path)
                                 else lbl_path[:-3])
            data = img.reshape(img.shape[0], 28, 28, 1)
            label = lbl.astype(np.int32)
        else:
            if self._synthetic is False:
                raise RuntimeError(
                    "MNIST files not found under %s (nothing is "
                    "downloaded); place %s there" % (self._root, files))
            warnings.warn("MNIST data not found under %s — using "
                          "deterministic synthetic data" % self._root)
            data, label = _synthetic(self._shape, self._classes,
                                     self._synthetic_n,
                                     seed=42 if self._train else 43)
        self._data = _array(data, dtype=np.uint8)
        self._label = label


class FashionMNIST(MNIST):

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None, synthetic=None):
        super().__init__(root, train, transform, synthetic)


class CIFAR10(_DownloadedDataset):
    """The binary batches under ``root``, else synthetic data."""

    _shape = (32, 32, 3)
    _classes = 10
    _synthetic_n = 2048

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None, synthetic=None):
        self._train = train
        self._synthetic = synthetic
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(
                -1, 3072 + 1)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(np.int32)

    def _get_data(self):
        if self._train:
            filenames = [os.path.join(self._root,
                                      "data_batch_%d.bin" % (i + 1))
                         for i in range(5)]
        else:
            filenames = [os.path.join(self._root, "test_batch.bin")]
        if all(os.path.exists(f) for f in filenames):
            data, label = zip(*[self._read_batch(f) for f in filenames])
            data = np.concatenate(data)
            label = np.concatenate(label)
        else:
            if self._synthetic is False:
                raise RuntimeError("CIFAR10 binaries not found under %s"
                                   % self._root)
            warnings.warn("CIFAR10 data not found under %s — using "
                          "deterministic synthetic data" % self._root)
            data, label = _synthetic(self._shape, self._classes,
                                     self._synthetic_n,
                                     seed=44 if self._train else 45)
        self._data = _array(data, dtype=np.uint8)
        self._label = label


class CIFAR100(CIFAR10):

    _classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None,
                 synthetic=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform, synthetic)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(
                -1, 3072 + 2)
        return data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0 + self._fine_label].astype(np.int32)

    def _get_data(self):
        fname = "train.bin" if self._train else "test.bin"
        path = os.path.join(self._root, fname)
        if os.path.exists(path):
            data, label = self._read_batch(path)
        else:
            if self._synthetic is False:
                raise RuntimeError("CIFAR100 binaries not found under %s"
                                   % self._root)
            warnings.warn("CIFAR100 data not found under %s — using "
                          "deterministic synthetic data" % self._root)
            data, label = _synthetic(self._shape, self._classes,
                                     self._synthetic_n,
                                     seed=46 if self._train else 47)
        self._data = _array(data, dtype=np.uint8)
        self._label = label


class ImageRecordDataset(dataset.RecordFileDataset):

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ....recordio import unpack_img
        record = super().__getitem__(idx)
        header, img = unpack_img(record)
        img = _array(img)
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(dataset.Dataset):
    """Images in a folder per class."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".npy"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                warnings.warn("Ignoring %s, which is not a directory." % path)
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    warnings.warn("Ignoring %s of type %s. Only support %s"
                                  % (filename, ext, ", ".join(self._exts)))
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        fname, label = self.items[idx]
        if fname.endswith(".npy"):
            img = np.load(fname)
        else:
            from PIL import Image
            img = np.asarray(Image.open(fname))
        img = _array(img)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
