"""The port's data path against the JAX package's, on the same files and
the same seeds. Tolerance 0 (bitwise) unless a case says otherwise.

- RecordIO: records written by either package are byte-identical, and
  each reads the other's; JPEG records written by the reference (PIL
  here) unpack to the reference's pixels, and decode natively to them.
- ``io``: ``NDArrayIter`` (shuffled under one ``np.random.seed``; pad,
  discard and roll_over), ``ResizeIter``, ``PrefetchingIter``, ``CSVIter``
  and ``MNISTIter`` give the reference's batches.
- ``ImageRecordIter``: the port's native pump (its own build of the same
  sources) gives the reference library's batches with cropping, mirroring,
  shuffling, resizing and normalization on; the pure-Python paths agree
  under one ``np.random.seed``.
- ``gluon.data``: samplers, datasets and ``DataLoader`` (threads too, and
  ``error_policy="skip"``) under one ``np.random.seed``; vision transforms
  and datasets; ``image.*`` and the augmenters. The resize is the
  reference's antialiased linear filter: on uint8-valued images its
  float output agrees within 5e-4 (2e-6 of the [0, 255] range; torch and
  XLA sum the taps in other orders), and a uint8 output within one level
  on under 1% of pixels (a float that lands near .5 may round the other
  way).
"""
import io as pyio
import logging
import os
import random
import struct
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import _native as jnative
from mxnet_tpu import image as jimage
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrec
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jtf
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _native as tnative
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402


@pytest.fixture(autouse=True)
def _block_names_as_found():
    """Leave both packages' block-name counters as this file found them:
    later tests in the same process compare parameter names that the
    counters number."""
    from mxnet_tpu.gluon import block as jblock
    from mxnet_tpu_torch.gluon import block as tblock
    saved = [(m, dict(m._global_counter)) for m in (jblock, tblock)]
    yield
    for m, counts in saved:
        m._global_counter.clear()
        m._global_counter.update(counts)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _images(n, h=20, w=24, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(h, w, 3) * 255).astype(np.uint8) for _ in range(n)]


def _write_rec(mod, path, imgs, fmt=".raw", indexed=False, vectors=True):
    """``imgs`` as records; with ``vectors`` every third label is a
    vector."""
    if indexed:
        rec = mod.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                    path, "w")
    else:
        rec = mod.MXRecordIO(path, "w")
    for i, img in enumerate(imgs):
        label = [float(i), 2.0 * i] if vectors and i % 3 == 0 \
            else float(i % 5)
        s = mod.pack_img(mod.IRHeader(0, label, i, 0), img, img_fmt=fmt)
        if indexed:
            rec.write_idx(i, s)
        else:
            rec.write(s)
    rec.close()
    return path


# ---- recordio -------------------------------------------------------------

@pytest.mark.parametrize("fmt,indexed", [(".raw", False), (".raw", True),
                                         (".png", True)])
def test_record_files_are_byte_identical(tmp_path, fmt, indexed):
    imgs = _images(6)
    a = _write_rec(jrec, str(tmp_path / "ref.rec"), imgs, fmt, indexed)
    b = _write_rec(trec, str(tmp_path / "own.rec"), imgs, fmt, indexed)
    assert open(a, "rb").read() == open(b, "rb").read()
    if indexed:
        assert open(a[:-4] + ".idx").read() == open(b[:-4] + ".idx").read()
    for reader, path in ((trec, a), (jrec, b)):
        r = reader.MXIndexedRecordIO(path[:-4] + ".idx", path, "r") \
            if indexed else reader.MXRecordIO(path, "r")
        for i, img in enumerate(imgs):
            raw = r.read_idx(i) if indexed else r.read()
            header, got = reader.unpack_img(raw)
            np.testing.assert_array_equal(got, img)
            assert header.id == i
        r.close()


def test_pack_unpack_match_reference():
    for label in (3.0, [1.0, 2.5, -4.0]):
        h = (0, label, 7, 9)
        s = trec.pack(h, b"payload")
        assert s == jrec.pack(h, b"payload")
        th, tp = trec.unpack(s)
        jh, jp = jrec.unpack(s)
        assert tp == jp == b"payload"
        np.testing.assert_array_equal(np.asarray(th.label),
                                      np.asarray(jh.label))


def test_reference_jpeg_records_read_by_the_port(tmp_path):
    imgs = _images(5, 40, 48, seed=7)
    path = _write_rec(jrec, str(tmp_path / "jpeg.rec"), imgs, ".jpg")
    r = trec.MXRecordIO(path, "r")
    q = jrec.MXRecordIO(path, "r")
    for _ in imgs:
        raw = r.read()
        assert raw == q.read()
        _same(trec.unpack_img(raw)[1], jrec.unpack_img(raw)[1])
    assert tnative.available() and tnative.has_jpeg()
    offs, lens = tnative.recordio_scan(path)
    roffs, rlens = jnative.recordio_scan(path)
    _same(offs, roffs)
    _same(lens, rlens)
    blob = np.fromfile(path, np.uint8)
    own = tnative.assemble_batch(blob, offs, lens, 3, 40, 48)
    ref = jnative.assemble_batch(blob, offs, lens, 3, 40, 48)
    _same(own, ref)


# ---- io -------------------------------------------------------------------

def _iter_batches(it):
    return [(_np(b.data), _np(b.label), b.pad) for b in it]


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarrayiter_matches_reference(handle):
    X = np.arange(70, dtype="float32").reshape(14, 5)
    Y = np.arange(14, dtype="float32")
    out = {}
    for name, mod in (("ref", jio), ("own", tio)):
        np.random.seed(5)
        it = mod.NDArrayIter(X, Y, batch_size=4, shuffle=True,
                             last_batch_handle=handle)
        first = _iter_batches(it)
        it.reset()
        out[name] = first + _iter_batches(it)
        out[name + "desc"] = [(d.name, d.shape) for d in it.provide_data]
    assert len(out["own"]) == len(out["ref"])
    for a, b in zip(out["own"], out["ref"]):
        _same(a[0], b[0])
        _same(a[1], b[1])
        assert a[2] == b[2]
    assert out["owndesc"] == out["refdesc"]


def test_resize_and_prefetching_iters_match_reference():
    X = np.random.RandomState(1).randn(12, 3).astype("float32")
    Y = np.arange(12, dtype="float32")
    got = {}
    for name, mod in (("ref", jio), ("own", tio)):
        base = mod.NDArrayIter(X, Y, batch_size=5)
        got[name] = _iter_batches(mod.ResizeIter(base, 7))
        pre = mod.PrefetchingIter([mod.NDArrayIter(X, Y, batch_size=4),
                                   mod.NDArrayIter(X * 2, Y, batch_size=4)])
        got[name] += _iter_batches(pre)
        pre.reset()
        got[name] += _iter_batches(pre)
        pre.close()
    assert len(got["own"]) == len(got["ref"]) == 13
    for a, b in zip(got["own"], got["ref"]):
        _same(a[0], b[0])
        _same(a[1], b[1])


def test_csv_and_mnist_iters_match_reference(tmp_path):
    rng = np.random.RandomState(2)
    data = rng.rand(9, 6).astype("float32")
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", np.arange(9.0), delimiter=",")
    img = (rng.rand(10, 28, 28) * 255).astype(np.uint8)
    lbl = rng.randint(0, 10, 10).astype(np.uint8)
    with open(tmp_path / "img", "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 3) + struct.pack(">III", 10, 28, 28)
                + img.tobytes())
    with open(tmp_path / "lbl", "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 1) + struct.pack(">I", 10)
                + lbl.tobytes())
    got = {}
    for name, mod in (("ref", jio), ("own", tio)):
        csv = mod.CSVIter(str(tmp_path / "d.csv"), (2, 3),
                          label_csv=str(tmp_path / "l.csv"), batch_size=4)
        np.random.seed(3)
        mn = mod.MNISTIter(str(tmp_path / "img"), str(tmp_path / "lbl"),
                           batch_size=4, shuffle=True)
        got[name] = _iter_batches(csv) + _iter_batches(mn)
    for a, b in zip(got["own"], got["ref"]):
        _same(a[0], b[0])
        _same(a[1], b[1])
        assert a[2] == b[2]


@pytest.fixture(scope="module")
def raw_rec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rec") / "imgs.rec")
    return _write_rec(jrec, path, _images(20, 36, 40, seed=4))


RECORD_KW = dict(data_shape=(3, 24, 28), batch_size=6, rand_crop=True,
                 rand_mirror=True, shuffle=True, resize=30, mean_r=120.0,
                 mean_g=110.0, mean_b=100.0, std_r=60.0, std_g=55.0,
                 std_b=50.0)


def test_image_record_iter_native_matches_reference(raw_rec):
    """The first epoch of each package's pump, bitwise. After a reset the
    reference's pump may serve a batch of the abandoned epoch (its reset
    does not wait for the producer); the port's waits, so two port
    iterators reset alike give the same second epoch."""
    assert jnative.available()
    ref = jio.ImageRecordIter(raw_rec, **RECORD_KW)
    own = tio.ImageRecordIter(raw_rec, **RECORD_KW)
    assert own.native and ref._pump is not None
    a, b = _iter_batches(own), _iter_batches(ref)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        _same(x[0], y[0])
        _same(x[1], y[1])
    second = []
    for it in (own, tio.ImageRecordIter(raw_rec, **RECORD_KW)):
        if it is not own:
            _iter_batches(it)
        it.reset()
        second.append(_iter_batches(it))
        it.close()
    assert len(second[0]) == len(second[1]) == 3
    for x, y in zip(*second):
        _same(x[0], y[0])
        _same(x[1], y[1])


def test_image_record_iter_python_path_matches_reference(raw_rec,
                                                         monkeypatch,
                                                         caplog):
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(jnative, "available", lambda: False)
    out = {}
    for name, mod in (("ref", jio), ("own", tio)):
        np.random.seed(9)
        with caplog.at_level(logging.INFO):
            it = mod.ImageRecordIter(raw_rec, **RECORD_KW)
        out[name] = _iter_batches(it)
    assert not it.native
    assert "pure-Python path" in caplog.text
    assert len(out["own"]) == 3
    for x, y in zip(out["own"], out["ref"]):
        np.testing.assert_allclose(x[0][0], y[0][0], rtol=0, atol=1e-6)
        _same(x[1], y[1])


# ---- gluon.data -----------------------------------------------------------

def test_samplers_and_datasets_match_reference():
    for name in ("Sequential", "Random"):
        for last in ("keep", "discard", "rollover"):
            res = []
            for mod in (jdata, tdata):
                np.random.seed(11)
                s = getattr(mod, name + "Sampler")(10)
                bs = mod.BatchSampler(s, 3, last)
                res.append((len(bs), [list(map(int, b)) for b in bs]
                            + [list(map(int, b)) for b in bs]))
            assert res[0] == res[1]
    X = np.arange(24, dtype="float32").reshape(8, 3)
    Y = np.arange(8, dtype="float32")
    out = []
    for mod, nd in ((jdata, jmx.nd), (tdata, None)):
        ds = mod.ArrayDataset(X, Y)
        simple = mod.SimpleDataset(list(range(10)))
        t = ds.transform_first(lambda x: x * 2)
        out.append([_np(ds[3]), _np(t[5]), len(ds),
                    list(simple.filter(lambda v: v % 3 == 0)),
                    list(simple.shard(3, 1)), list(simple.take(4)),
                    _np(list(ds.transform(lambda x, y: (x + y, y),
                                          lazy=False)[2]))])
    for a, b in zip(*out):
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            _same(a, b)
        else:
            assert np.array_equal(np.asarray(a, dtype=object).astype(float),
                                  np.asarray(b, dtype=object).astype(float))


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_matches_reference(workers):
    X = np.random.RandomState(3).randn(11, 4).astype("float32")
    Y = np.arange(11).astype("float32")
    out = []
    for mod in (jdata, tdata):
        np.random.seed(13)
        dl = mod.DataLoader(mod.ArrayDataset(X, Y), batch_size=4,
                            shuffle=True, last_batch="keep",
                            num_workers=workers)
        out.append([(_np(x), _np(y)) for x, y in dl])
    assert len(out[0]) == len(out[1]) == 3
    for (a, b), (c, d) in zip(*out):
        _same(a, c)
        _same(b, d)
    with tmx.cpu():
        x, _ = next(iter(tdata.DataLoader(tdata.ArrayDataset(X, Y),
                                          batch_size=4)))
    assert x.ctx == tmx.cpu()


def test_dataloader_skip_policy_matches_reference():
    class Bad:
        def __init__(self, bad):
            self.bad = bad

        def __len__(self):
            return 12

        def __getitem__(self, i):
            if i in self.bad:
                raise ValueError("corrupt sample %d" % i)
            return np.full((2,), i, "float32")

    for mod in (jdata, tdata):
        dl = mod.DataLoader(Bad({1, 5, 6}), batch_size=4,
                            error_policy="skip", max_skips=5)
        got = [_np(b) for b in dl]
        assert [len(b) for b in got] == [3, 2, 4]
        with pytest.raises(mod.DataLoaderSkipLimit):
            list(mod.DataLoader(Bad(set(range(8))), batch_size=4,
                                error_policy="skip", max_skips=5))
        with pytest.raises(ValueError, match="corrupt"):
            list(mod.DataLoader(Bad({2}), batch_size=4))


def test_vision_transforms_match_reference():
    img = _images(1, 30, 26, seed=5)[0]
    cases = [
        lambda m: m.ToTensor(),
        lambda m: m.Compose([m.ToTensor(),
                             m.Normalize((0.5, 0.4, 0.3), (0.2, 0.25, 0.3))]),
        lambda m: m.Cast("float32"),
        lambda m: m.RandomFlipLeftRight(),
        lambda m: m.RandomFlipTopBottom(),
        lambda m: m.RandomBrightness(0.3),
        lambda m: m.RandomContrast(0.3),
        lambda m: m.RandomSaturation(0.3),
        lambda m: m.RandomColorJitter(0.2, 0.2, 0.2),
        lambda m: m.RandomLighting(0.1),
    ]
    for make in cases:
        out = []
        for mod, nd in ((jtf, jmx.nd), (ttf, None)):
            np.random.seed(17)
            x = nd.array(img, dtype="uint8") if nd is not None \
                else tmx.nd.NDArray(img, ctx=tmx.cpu())
            out.append([_np(make(mod)(x)) for _ in range(3)])
        for a, b in zip(*out):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("make", [
    lambda m: m.Resize(13), lambda m: m.Resize((17, 11)),
    lambda m: m.Resize(14, keep_ratio=True), lambda m: m.CenterCrop(20),
    lambda m: m.CenterCrop(40), lambda m: m.RandomResizedCrop(16)])
def test_vision_resizing_transforms_match_reference(make):
    img = _images(1, 30, 26, seed=6)[0]
    out = []
    for mod, ctor in ((jtf, lambda v: jmx.nd.array(v, dtype="uint8")),
                      (ttf, lambda v: tmx.nd.NDArray(v, ctx=tmx.cpu()))):
        np.random.seed(19)
        out.append(_np(make(mod)(ctor(img))))
    assert out[0].shape == out[1].shape
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=5e-4)


def test_image_functions_match_reference():
    img = _images(1, 33, 41, seed=8)[0]
    j = jmx.nd.array(img, dtype="uint8")
    t = tmx.nd.NDArray(img, ctx=tmx.cpu())
    r = jimage.imresize(j, 17, 12).asnumpy()
    o = timage.imresize(t, 17, 12).asnumpy()
    assert o.dtype == r.dtype == np.uint8
    assert np.abs(o.astype(int) - r.astype(int)).max() <= 1
    assert np.mean(o != r) < 0.01
    f = timage.imresize(t.astype("float32"), 50, 44).asnumpy()
    np.testing.assert_allclose(
        f, jimage.imresize(j.astype("float32"), 50, 44).asnumpy(), atol=5e-4)
    assert timage.resize_short(t, 20).shape == \
        jimage.resize_short(j, 20).shape
    for fn in ("random_crop", "center_crop"):
        random.seed(4)
        a, ra = getattr(jimage, fn)(j, (16, 14))
        random.seed(4)
        b, rb = getattr(timage, fn)(t, (16, 14))
        assert ra == rb
        _same(b, a)
    random.seed(6)
    np.random.seed(6)
    a = jimage.random_size_crop(j, (10, 10), 0.3, (0.75, 1.33))[1]
    random.seed(6)
    np.random.seed(6)
    b = timage.random_size_crop(t, (10, 10), 0.3, (0.75, 1.33))[1]
    assert a == b
    _same(timage.fixed_crop(t, 3, 4, 10, 8), jimage.fixed_crop(j, 3, 4, 10, 8))
    _same(timage.copyMakeBorder(t, 1, 2, 3, 4),
          jimage.copyMakeBorder(j, 1, 2, 3, 4))
    np.testing.assert_allclose(
        timage.color_normalize(t, [120.0, 110.0, 100.0], [50.0, 60.0, 70.0])
        .asnumpy(),
        jimage.color_normalize(j, jmx.nd.array([120.0, 110.0, 100.0]),
                               jmx.nd.array([50.0, 60.0, 70.0])).asnumpy(),
        rtol=1e-6)
    buf = pyio.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    _same(timage.imdecode(buf.getvalue()), jimage.imdecode(buf.getvalue()))


def test_augmenters_and_image_iter_match_reference(tmp_path):
    img = _images(1, 30, 34, seed=9)[0]
    kw = dict(resize=28, rand_crop=True, rand_mirror=True, mean=True,
              std=True, brightness=0.2, contrast=0.2, saturation=0.2,
              pca_noise=0.1)
    out = []
    for mod, arr in ((jimage, jmx.nd.array(img, dtype="uint8")),
                     (timage, tmx.nd.NDArray(img, ctx=tmx.cpu()))):
        augs = mod.CreateAugmenter((3, 20, 22), **kw)
        random.seed(21)
        np.random.seed(21)
        x = arr
        for aug in augs:
            x = aug(x)
        out.append((_np(x), [a.dumps() for a in augs]))
    assert out[0][1] == out[1][1]
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5, atol=1e-3)
    png = _write_rec(jrec, str(tmp_path / "png.rec"),
                     _images(20, 36, 40, seed=4), ".png", vectors=False)
    got = []
    for mod in (jimage, timage):
        random.seed(23)
        it = mod.ImageIter(4, (3, 24, 28), path_imgrec=png, shuffle=True,
                           rand_crop=True, rand_mirror=True)
        got.append(_iter_batches(it))
    assert len(got[0]) == len(got[1]) == 5
    for a, b in zip(*got):
        _same(a[0], b[0])
        _same(a[1], b[1])


def test_vision_datasets_match_reference(tmp_path):
    _write_rec(jrec, str(tmp_path / "idx.rec"), _images(5, 12, 14, seed=2),
               indexed=True, vectors=False)
    for cls in ("a", "b"):
        os.makedirs(tmp_path / "folder" / cls)
        for i, im in enumerate(_images(2, 8, 8, seed=ord(cls))):
            np.save(tmp_path / "folder" / cls / ("%d.npy" % i), im)
    from mxnet_tpu.gluon.data import vision as jv
    from mxnet_tpu_torch.gluon.data import vision as tv
    got = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for v in (jv, tv):
            rec = v.ImageRecordDataset(str(tmp_path / "idx.rec"))
            folder = v.ImageFolderDataset(str(tmp_path / "folder"))
            mnist = v.MNIST(root=str(tmp_path / v.__name__ / "m"))
            cifar = v.CIFAR10(root=str(tmp_path / v.__name__ / "c"),
                              train=False)
            got.append([_np(rec[3][0]), np.asarray(rec[3][1]), len(rec),
                        _np(folder[3][0]), folder[3][1], folder.synsets,
                        _np(mnist[7][0]), int(mnist[7][1]), len(mnist),
                        _np(cifar[5][0]), int(cifar[5][1])])
    for a, b in zip(*got):
        if isinstance(a, np.ndarray):
            _same(a, b)
        else:
            assert a == b
    with pytest.raises(RuntimeError):
        tv.CIFAR100(root=str(tmp_path / "none"), synthetic=False)
    with pytest.raises(RuntimeError):
        tv.MNIST(root=str(tmp_path / "none2"), synthetic=False)
    loader = tdata.DataLoader(
        tv.ImageRecordDataset(str(tmp_path / "idx.rec")).transform_first(
            ttf.Compose([ttf.ToTensor(), ttf.Normalize(0.5, 0.25)])),
        batch_size=2)
    x, y = next(iter(loader))
    assert x.shape == (2, 3, 12, 14) and x.ctx == tmx.cpu()
