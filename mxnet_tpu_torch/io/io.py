"""Data iterators.

Counterpart of ``mxnet_tpu/io/io.py`` (the reference's
``python/mxnet/io/io.py``): ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter``, and the wrappers of
MXNet's C++ iterators, ``CSVIter``, ``MNISTIter`` and ``ImageRecordIter``.

Batches are NDArrays on the CPU, as MXNet's iterators give them (the
reference puts them on its default device): the device copy belongs to
:class:`~mxnet_tpu_torch.parallel.datafeed.DeviceFeed`, which stages them
through pinned buffers ahead of the step that consumes them.

``ImageRecordIter`` decodes and augments on the native pump
(``_native.Pump``, the port's build of the reference's ``src/io``
sources) when the library builds, and on the reference's pure-Python path
otherwise; ``ImageRecordIter.native`` says which, and the choice is
logged. The same library and arguments give the reference's batches bit
for bit, and so does the Python path under one ``np.random.seed``.
"""
from __future__ import annotations

import logging
import threading
from collections import namedtuple

import numpy as _np

from ..base import MXNetError
from ..context import cpu
from ..ndarray.ndarray import NDArray

_log = logging.getLogger(__name__)


def _host(value, dtype=None):
    """``value`` as an NDArray on the CPU."""
    return NDArray(value, ctx=cpu(), dtype=dtype)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "ImageRecordIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """A data or label array's name, shape, dtype and layout."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One batch: data and label arrays, the pad and the index."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), "Data must be list of NDArrays"
        if label is not None:
            assert isinstance(label, (list, tuple)), "Label must be list of NDArrays"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


class DataIter:
    """Base of the iterators."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


def _init_data(data, allow_empty, default_name):
    """``data`` as a sorted list of ``(name, NDArray)``."""
    assert (data is not None) or allow_empty
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    for k, v in data.items():
        if not isinstance(v, NDArray):
            try:
                data[k] = _host(v)
            except Exception:
                raise TypeError("Invalid type '%s' for %s" % (type(v), k))
    return list(sorted(data.items()))


class NDArrayIter(DataIter):
    """Iterator over in-memory arrays."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = _np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.batch_size = batch_size
        self.cursor = -self.batch_size
        self.num_data = self.idx.shape[0]
        self._cache_data = None
        self._cache_label = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.label]

    def hard_reset(self):
        if self.shuffle:
            self._shuffle_data()
        self.cursor = -self.batch_size
        self._cache_data = None
        self._cache_label = None

    def reset(self):
        if self.shuffle:
            self._shuffle_data()
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        data = self.getdata()
        label = self.getlabel()
        if data[0].shape[0] != self.batch_size:
            if self.last_batch_handle == "discard":
                raise StopIteration
            if self.last_batch_handle == "pad":
                data = self._pad_batch(data)
                label = self._pad_batch(label)
        return DataBatch(data=data, label=label, pad=self.getpad(),
                         index=None)

    def _pad_batch(self, arrs):
        out = []
        for a in arrs:
            n = a.shape[0]
            if n == self.batch_size:
                out.append(a)
                continue
            pad = self.batch_size - n
            out.append(_host(_np.concatenate(
                [a.asnumpy(), _np.zeros((pad,) + a.shape[1:],
                                        dtype=a.dtype)]), dtype=a.dtype))
        return out

    def _getdata(self, data_source, start=None, end=None):
        assert start is not None or end is not None
        if start is None:
            start = 0
        if end is None:
            end = data_source[0][1].shape[0] if data_source else 0
        s = slice(start, end)
        return [
            x[1][s] if isinstance(x[1], NDArray) else _host(x[1][s])
            for x in data_source
        ]

    def getdata(self):
        start = self.cursor
        end = min(self.cursor + self.batch_size, self.num_data)
        return self._getdata(self.data, start, end)

    def getlabel(self):
        start = self.cursor
        end = min(self.cursor + self.batch_size, self.num_data)
        return self._getdata(self.label, start, end)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        if self.last_batch_handle == "roll_over" and -self.batch_size < \
                self.cursor < 0:
            return -self.cursor
        return 0

    def _shuffle_data(self):
        perm = _np.random.permutation(self.num_data)
        self.data = [(k, _host(v.asnumpy()[perm]
                               if isinstance(v, NDArray)
                               else _np.asarray(v)[perm]))
                     for k, v in self.data]
        self.label = [(k, _host(v.asnumpy()[perm]
                                if isinstance(v, NDArray)
                                else _np.asarray(v)[perm]))
                      for k, v in self.label]


class ResizeIter(DataIter):
    """An iterator with its epoch cut or stretched to ``size`` batches."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Double-buffered prefetch over one or more iterators (reference
    io.py:535; C++ `src/io/iter_prefetcher.h`). A background thread stages
    the next host batch while the device computes the current one."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]
        self.next_error = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                    self.next_error[i] = None
                except StopIteration:
                    self.next_batch[i] = None
                    self.next_error[i] = None
                except Exception as e:  # noqa: BLE001 — relay, never wedge
                    # the handshake MUST complete even on a source fault:
                    # a dead prefetch thread would leave data_ready forever
                    # unset and hang the consumer (and reset()) instead of
                    # surfacing the error
                    self.next_batch[i] = None
                    self.next_error[i] = e
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i], daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def close(self):
        """Stop AND join the prefetch threads (idempotent). ``__del__``
        only signals them without joining — call ``close()`` when the
        underlying iterators are about to be reused elsewhere."""
        self.started = False
        for e in self.data_taken:
            e.set()
        for t in getattr(self, "prefetch_threads", []):
            t.join(timeout=2.0)

    def __del__(self):
        try:
            self.started = False
            for e in self.data_taken:
                e.set()
        except Exception:
            pass

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[
            DataDesc(r[x.name], x.shape, x.dtype)
            if isinstance(x, DataDesc) else DataDesc(*x)
            for x in i.provide_data
        ] for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[
            DataDesc(r[x.name], x.shape, x.dtype)
            if isinstance(x, DataDesc) else DataDesc(*x)
            for x in i.provide_label
        ] for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        # wait for any in-flight fetch to land (the handshake guarantees
        # data_ready is eventually set even when the source raised — see
        # prefetch_func), discard it, and restart the underlying iters
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        self.next_error = [None for _ in range(self.n_iter)]
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        errs = [e for e in self.next_error if e is not None]
        if errs:
            # propagate the source fault to the consumer, re-arming ONLY
            # the errored slots so the handshake (and reset()) stays live
            # — a non-failing iterator's already-fetched batch must not be
            # clobbered by an early refetch
            for i, err in enumerate(self.next_error):
                if err is not None:
                    self.data_ready[i].clear()
                    self.data_taken[i].set()
            raise errs[0]
        if self.next_batch[0] is None:
            for i in self.next_batch:
                assert i is None, "Number of entry mismatches between iterators"
            # exhausted, but re-armable: reset() restarts the underlying
            # iters and the handshake below resumes fetching
            return False
        for batch in self.next_batch:
            assert batch.pad == self.next_batch[0].pad, \
                "Number of entry mismatches between iterators"
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class CSVIter(NDArrayIter):
    """CSV file iterator (reference C++ `src/io/iter_csv.cc`; same kwargs)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        data = _np.loadtxt(data_csv, delimiter=",", dtype="float32")
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype="float32")
            label = label.reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="pad" if round_batch else "discard")


class MNISTIter(NDArrayIter):
    """MNIST idx-format iterator (reference `src/io/iter_mnist.cc`)."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 input_shape=None, **kwargs):
        import gzip
        import os
        import struct

        def read_idx(path):
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rb") as f:
                zero, dtype, dims = struct.unpack(">HBB", f.read(4))
                shape = tuple(struct.unpack(">I", f.read(4))[0]
                              for _ in range(dims))
                return _np.frombuffer(f.read(), dtype=_np.uint8).reshape(shape)

        if not os.path.exists(image) and not os.path.exists(image + ".gz"):
            raise MXNetError("MNIST file %s not found (nothing is "
                             "downloaded; use gluon.data.vision.MNIST with a "
                             "local root or synthetic=True)" % image)
        img = read_idx(image if os.path.exists(image) else image + ".gz")
        lbl = read_idx(label if os.path.exists(label) else label + ".gz")
        img = img.astype("float32") / 255.0
        if flat:
            img = img.reshape(img.shape[0], -1)
        else:
            img = img.reshape(img.shape[0], 1, img.shape[1], img.shape[2])
        super().__init__(img, lbl.astype("float32"), batch_size=batch_size,
                         shuffle=shuffle)


def _resize_shorter_bilinear(img, size):
    """Shorter-edge bilinear resize with half-pixel centers, the native
    pump's convention (``csrc/io/recordio.cc`` ``resize_bilinear``)."""
    ih, iw = img.shape[:2]
    if min(ih, iw) == size:
        return img
    if ih < iw:
        nh, nw = size, iw * size // ih
    else:
        nh, nw = ih * size // iw, size
    src = img.astype(_np.float64)
    ys = (_np.arange(nh) + 0.5) * ih / nh - 0.5
    xs = (_np.arange(nw) + 0.5) * iw / nw - 0.5
    y0 = _np.clip(_np.floor(ys).astype(int), 0, ih - 1)
    x0 = _np.clip(_np.floor(xs).astype(int), 0, iw - 1)
    y1 = _np.clip(y0 + 1, 0, ih - 1)
    x1 = _np.clip(x0 + 1, 0, iw - 1)
    wy = _np.clip(ys - y0, 0, 1)[:, None, None]
    wx = _np.clip(xs - x0, 0, 1)[None, :, None]
    v = ((1 - wy) * ((1 - wx) * src[y0][:, x0] + wx * src[y0][:, x1]) +
         wy * ((1 - wx) * src[y1][:, x0] + wx * src[y1][:, x1]))
    return _np.floor(v + 0.5).clip(0, 255).astype(img.dtype)


class ImageRecordIter(DataIter):
    """RecordIO image iterator (the reference's
    ``src/io/iter_image_recordio_2.cc``): augmented NCHW float32 batches
    of a ``.rec`` file. ``native`` is True when the native pump serves
    them (its RNG seeded with 0, as the reference's is). After ``reset()``
    the pump serves the epoch after the last one a batch was taken from
    (the reference's pump may serve a batch of the abandoned epoch, and
    skip an epoch, depending on how far ahead its thread had run)."""

    def __init__(self, path_imgrec, data_shape, batch_size=1,
                 label_width=1, shuffle=False, resize=0, mean_r=0.0,
                 mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0,
                 rand_crop=False, rand_mirror=False, preprocess_threads=None,
                 prefetch_buffer=4, random_h=0, random_s=0, random_l=0,
                 **kwargs):
        if preprocess_threads is None:
            from .. import config as _config
            preprocess_threads = _config.get("MXNET_CPU_WORKER_NTHREADS",
                                             default=4)
        super().__init__(batch_size)
        self._pump = None
        from .. import _native
        if _native.available():
            try:
                # one record decoded natively checks the payload format
                # before the pump takes the file
                offs, lens = _native.recordio_scan(path_imgrec)
                blob = _np.fromfile(path_imgrec, _np.uint8)
                failed = _native.decode_failures()
                _native.assemble_batch(blob, offs[:1], lens[:1],
                                       *tuple(data_shape), resize=resize)
                if _native.decode_failures() != failed:
                    # a JPEG record where the library was built without
                    # libjpeg: it would serve zero-filled images
                    raise _native.NativeError("record 0 does not decode")
                self._pump = _native.Pump(
                    path_imgrec, batch_size, tuple(data_shape),
                    resize=resize, mean=[mean_r, mean_g, mean_b],
                    std=[std_r, std_g, std_b], rand_crop=rand_crop,
                    rand_mirror=rand_mirror, shuffle=shuffle,
                    depth=int(prefetch_buffer), random_h=random_h,
                    random_s=random_s, random_l=random_l)
            except _native.NativeError as e:
                _log.warning("ImageRecordIter(%s): the native pump refused "
                             "the file (%s)", path_imgrec, e)
                self._pump = None
        self.native = self._pump is not None
        _log.info("ImageRecordIter(%s): %s path", path_imgrec,
                  "native pump" if self.native else "pure-Python")
        if not self.native and (random_h or random_s or random_l):
            _log.warning(
                "ImageRecordIter: the native pump is unavailable and the "
                "pure-Python path has no HLS jitter: random_h/random_s/"
                "random_l are ignored")
        self._data_shape = tuple(data_shape)
        self._batch_size = batch_size
        self._label_width = label_width
        if self.native:
            return
        from ..recordio import MXRecordIO
        rec = MXRecordIO(path_imgrec, "r")
        self._shuffle = shuffle
        self._aug = dict(rand_crop=rand_crop, rand_mirror=rand_mirror,
                         resize=resize,
                         mean=_np.array([mean_r, mean_g, mean_b]),
                         std=_np.array([std_r, std_g, std_b]))
        self._items = []
        while True:
            raw = rec.read()
            if raw is None:
                break
            self._items.append(raw)
        rec.close()
        self._order = _np.arange(len(self._items))
        self._cursor = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self._batch_size,) + self._data_shape)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self._batch_size,))]

    def reset(self):
        if self._pump is not None:
            self._pump.reset()
            return
        if self._shuffle:
            _np.random.shuffle(self._order)
        self._cursor = 0

    def next(self):
        if self._pump is not None:
            item = self._pump.next()
            if item is None:
                raise StopIteration
            data, label = item
            return DataBatch(data=[_host(data)], label=[_host(label)], pad=0,
                             index=None)
        from ..recordio import unpack_img
        if self._cursor + self._batch_size > len(self._items):
            raise StopIteration
        data = _np.zeros((self._batch_size,) + self._data_shape, "float32")
        label = _np.zeros((self._batch_size,), "float32")
        c, h, w = self._data_shape
        for i in range(self._batch_size):
            raw = self._items[self._order[self._cursor + i]]
            header, img = unpack_img(raw)
            label[i] = header.label if _np.isscalar(header.label) \
                else header.label[0]
            if img.ndim == 2:
                img = _np.stack([img] * c, axis=2)
            rs = self._aug["resize"]
            if rs:
                img = _resize_shorter_bilinear(img.astype("uint8"), rs)
            img = img.astype("float32")
            ih, iw = img.shape[:2]
            if self._aug["rand_crop"] and ih >= h and iw >= w:
                y0 = _np.random.randint(0, ih - h + 1)
                x0 = _np.random.randint(0, iw - w + 1)
            else:
                y0, x0 = max(0, (ih - h) // 2), max(0, (iw - w) // 2)
            crop = img[y0:y0 + h, x0:x0 + w]
            if crop.shape[:2] != (h, w):
                cy = _np.zeros((h, w, c), "float32")
                cy[:crop.shape[0], :crop.shape[1]] = crop
                crop = cy
            if self._aug["rand_mirror"] and _np.random.rand() < 0.5:
                crop = crop[:, ::-1]
            crop = (crop - self._aug["mean"]) / self._aug["std"]
            data[i] = crop.transpose(2, 0, 1)
        self._cursor += self._batch_size
        return DataBatch(data=[_host(data)], label=[_host(label)], pad=0,
                         index=None)

    def close(self):
        """Stop the native pump's threads (the iterator is spent)."""
        if self._pump is not None:
            self._pump.close()
