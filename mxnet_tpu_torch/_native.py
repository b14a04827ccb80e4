"""ctypes bridge to the native IO library: RecordIO scanning, batch decode
and augmentation, and the prefetch pump.

Counterpart of ``mxnet_tpu/_native.py``. The sources are the port's own
copy of the reference's ``src/io/recordio.cc`` and ``src/io/pump.cc``
(``csrc/io/``). At first use they are compiled with ``g++ -O3 -fopenmp``,
the reference's flags, into ``build/native/libmxtpu_io-<digest>.so`` at
the root of the checkout (the digest covers the sources, the header and
the flags). Where ``<jpeglib.h>`` compiles, the build defines
``MXTPU_HAVE_JPEG`` and links ``-ljpeg``; elsewhere JPEG payloads fail to
decode (zero-filled and counted) and the raw container is the only image
format. :func:`available` gates use: the Python paths of the callers cover
a machine without a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "build", "lib", "check_call", "NativeError",
           "recordio_scan", "assemble_batch", "assemble_batch_u8", "Pump",
           "has_jpeg", "decode_failures", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc" / "io"
BUILD_DIR = _PKG.parent / "build" / "native"
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared")
_log = logging.getLogger(__name__)
_lock = threading.Lock()
_lib = None
_jpeg = None
_build_attempted = False


class NativeError(RuntimeError):
    pass


def _jpeg_headers():
    """Whether ``<jpeglib.h>`` compiles and ``-ljpeg`` links here."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        src = os.path.join(d, "probe.cc")
        with open(src, "w") as f:
            f.write("#include <cstdio>\n#include <jpeglib.h>\n"
                    "int main() { jpeg_decompress_struct c;"
                    " (void)c; return 0; }\n")
        res = subprocess.run(["g++", src, "-o", os.path.join(d, "probe"),
                              "-ljpeg"], capture_output=True, timeout=120)
        return res.returncode == 0


def _target(jpeg):
    flags = _CXXFLAGS + (("-DMXTPU_HAVE_JPEG",) if jpeg else ())
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(_SRC.iterdir()):
        h.update(b"\0" + f.name.encode() + b"\0" + f.read_bytes())
    return flags, BUILD_DIR / ("libmxtpu_io-%s.so" % h.hexdigest()[:16])


def build(verbose=False):
    """Compile the library (if missing) and load it; returns True. Raises
    :class:`NativeError` with the compiler's output when the build
    fails."""
    global _lib, _jpeg
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jpeg = _jpeg_headers()
        flags, path = _target(jpeg)
        if not path.exists():
            tmp = path.with_name(path.name + ".%d.tmp" % os.getpid())
            cmd = ["g++", *flags, "-o", str(tmp),
                   str(_SRC / "recordio.cc"), str(_SRC / "pump.cc")]
            if jpeg:
                cmd.append("-ljpeg")
            res = subprocess.run(cmd, capture_output=not verbose, text=True,
                                 timeout=600)
            if res.returncode != 0:
                raise NativeError("native IO build failed: %s"
                                  % (res.stderr or "")[-2000:])
            os.replace(tmp, path)
        _lib = _bind(ctypes.CDLL(str(path)))
        _jpeg = jpeg
        _log.info("native IO library %s (JPEG %s)", path,
                  "on" if jpeg else "off: no <jpeglib.h>")
    return True


def _bind(lib):
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    vp, ci, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
    lib.mxtpu_last_error.restype = ctypes.c_char_p
    lib.mxtpu_decode_failures.restype = ctypes.c_int64
    lib.mxtpu_recordio_scan.restype = ctypes.c_int64
    lib.mxtpu_recordio_scan.argtypes = [ctypes.c_char_p, c_i64p, c_i64p,
                                        ctypes.c_int64]
    lib.mxtpu_recordio_count.restype = ctypes.c_int64
    lib.mxtpu_recordio_count.argtypes = [ctypes.c_char_p]
    lib.mxtpu_assemble_batch_aug.restype = ci
    lib.mxtpu_assemble_batch_aug.argtypes = [
        vp, c_i64p, c_i64p, ci, ci, ci, ci, ci, vp, vp, ci, u64, ci, ci, ci,
        vp, vp]
    lib.mxtpu_assemble_batch_u8_aug.restype = ci
    lib.mxtpu_assemble_batch_u8_aug.argtypes = [
        vp, c_i64p, c_i64p, ci, ci, ci, ci, ci, ci, u64, ci, ci, ci, vp, vp]
    lib.mxtpu_pump_create.restype = vp
    lib.mxtpu_pump_create.argtypes = [
        ctypes.c_char_p, ci, ci, ci, ci, ci, ci, vp, vp, ci, ci, u64, ci]
    lib.mxtpu_pump_next.restype = ci
    lib.mxtpu_pump_next.argtypes = [vp, vp, vp]
    lib.mxtpu_pump_reset.argtypes = [vp]
    lib.mxtpu_pump_batches_per_epoch.restype = ci
    lib.mxtpu_pump_batches_per_epoch.argtypes = [vp]
    lib.mxtpu_pump_destroy.argtypes = [vp]
    return lib


def _try_load():
    global _build_attempted
    if _lib is not None:
        return _lib
    if _build_attempted:
        return None
    _build_attempted = True
    try:
        build()
    except (NativeError, OSError, subprocess.SubprocessError) as e:
        _log.warning("native IO library unavailable: %s", e)
        return None
    return _lib


def available():
    """Whether the library is built and loaded (building it at the first
    call)."""
    return _try_load() is not None


def has_jpeg():
    """Whether the loaded library decodes JPEG payloads."""
    lib()
    return bool(_jpeg)


def lib():
    l = _try_load()
    if l is None:
        raise NativeError("the native IO library is not available; "
                          "mxnet_tpu_torch._native.build() says why")
    return l


def check_call(ret):
    if ret < 0:
        raise NativeError(lib().mxtpu_last_error().decode())
    return ret


def decode_failures():
    """Records zero-filled so far because they failed to decode."""
    return lib().mxtpu_decode_failures()


def recordio_scan(path):
    """Record framing of a ``.rec`` file: ``(offsets, lengths)`` int64
    arrays of each payload."""
    l = lib()
    n = check_call(l.mxtpu_recordio_count(str(path).encode()))
    offsets = np.zeros(n, np.int64)
    lengths = np.zeros(n, np.int64)
    check_call(l.mxtpu_recordio_scan(
        str(path).encode(),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n))
    return offsets, lengths


def _blob_ptr(blob):
    if isinstance(blob, np.ndarray):
        return blob.ctypes.data_as(ctypes.c_void_p), blob
    buf = ctypes.create_string_buffer(blob, len(blob))
    return ctypes.cast(buf, ctypes.c_void_p), buf


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def assemble_batch(blob, offsets, lengths, c, h, w, resize=0, mean=None,
                   std=None, aug_flags=0, seed=0, random_h=0, random_s=0,
                   random_l=0):
    """Decode ``len(offsets)`` records of ``blob`` into float32 NCHW, in
    parallel; ``random_h/s/l`` are the HLS jitter ranges."""
    l = lib()
    n = len(offsets)
    out = np.empty((n, c, h, w), np.float32)
    labels = np.empty(n, np.float32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    keep = []
    ptrs = []
    for v in (mean, std):
        if v is None:
            ptrs.append(None)
        else:
            v = np.ascontiguousarray(v, np.float32)
            keep.append(v)
            ptrs.append(v.ctypes.data_as(ctypes.c_void_p))
    bp, _hold = _blob_ptr(blob)
    check_call(l.mxtpu_assemble_batch_aug(
        bp, _i64p(offsets), _i64p(lengths), n, c, h, w, resize, ptrs[0],
        ptrs[1], aug_flags, seed, int(random_h), int(random_s),
        int(random_l), out.ctypes.data_as(ctypes.c_void_p),
        labels.ctypes.data_as(ctypes.c_void_p)))
    return out, labels


def assemble_batch_u8(blob, offsets, lengths, c, h, w, resize=0,
                      aug_flags=0, seed=0, random_h=0, random_s=0,
                      random_l=0):
    """The uint8 NHWC variant (no normalization)."""
    l = lib()
    n = len(offsets)
    out = np.empty((n, h, w, c), np.uint8)
    labels = np.empty(n, np.float32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    bp, _hold = _blob_ptr(blob)
    check_call(l.mxtpu_assemble_batch_u8_aug(
        bp, _i64p(offsets), _i64p(lengths), n, c, h, w, resize, aug_flags,
        seed, int(random_h), int(random_s), int(random_l),
        out.ctypes.data_as(ctypes.c_void_p),
        labels.ctypes.data_as(ctypes.c_void_p)))
    return out, labels


class Pump:
    """The native batch producer (``csrc/io/pump.cc``): its own threads
    decode and augment batches of a ``.rec`` file ahead of the consumer,
    with their own RNG from ``seed``."""

    def __init__(self, path, batch_size, data_shape, resize=0, mean=None,
                 std=None, rand_crop=False, rand_mirror=False, shuffle=False,
                 seed=0, depth=2, u8_output=False, random_h=0, random_s=0,
                 random_l=0):
        l = lib()
        c, h, w = data_shape
        self._u8 = bool(u8_output)
        self._shape = (batch_size, h, w, c) if self._u8 \
            else (batch_size, c, h, w)
        # bits 0-7: crop/mirror; 8-15/16-23/24-31: the HLS jitter ranges
        aug = (1 if rand_mirror else 0) | (2 if rand_crop else 0) | \
            ((int(random_h) & 0xff) << 8) | ((int(random_s) & 0xff) << 16) | \
            ((int(random_l) & 0xff) << 24)
        mean_p = std_p = None
        if mean is not None:
            self._mean = np.ascontiguousarray(mean, np.float32)
            mean_p = self._mean.ctypes.data_as(ctypes.c_void_p)
        if std is not None:
            self._std = np.ascontiguousarray(std, np.float32)
            std_p = self._std.ctypes.data_as(ctypes.c_void_p)
        self._h = l.mxtpu_pump_create(str(path).encode(), batch_size, c, h,
                                      w, resize, int(self._u8), mean_p,
                                      std_p, aug, int(shuffle), seed, depth)
        if not self._h:
            raise NativeError("pump creation failed for %s" % path)
        self._lib = l

    @property
    def batches_per_epoch(self):
        return self._lib.mxtpu_pump_batches_per_epoch(self._h)

    def next(self):
        """``(data, labels)``, or None at the epoch's end."""
        out = np.empty(self._shape, np.uint8 if self._u8 else np.float32)
        labels = np.empty(self._shape[0], np.float32)
        r = self._lib.mxtpu_pump_next(
            self._h, out.ctypes.data_as(ctypes.c_void_p),
            labels.ctypes.data_as(ctypes.c_void_p))
        if r == 1:
            return None
        check_call(r)
        return out, labels

    def reset(self):
        self._lib.mxtpu_pump_reset(self._h)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.mxtpu_pump_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
