"""``.states`` files in the JAX package's format, read and written
without importing ``jax`` or ``mxnet_tpu``.

The reference's ``Updater.get_states`` pickles its states dict (index ->
``NDArray``, a tuple of them, or None), with its optimizer when
``dump_optimizer``. Its ``NDArray`` holds a ``jax.Array``, which pickles
through ``jax._src.array._reconstruct_array``; its optimizer pickles its
``param_dict`` of ``Parameter``s (with their ``Context``s and tape
``Leaf``s). One format serves both packages:

- :func:`dumps` writes that format, naming the reference's globals by
  string: each state tensor becomes a reference ``NDArray`` whose data is
  ``jax.numpy.asarray(<numpy array>[, "bfloat16"])`` (a bf16 tensor goes
  as float32 values and the dtype name, so neither side needs
  ``ml_dtypes``), on ``cpu(0)``; the optimizer and its learning-rate
  scheduler become the reference's classes of the same names, with the
  port's attributes. ``param_dict`` is written empty, as upstream MXNet's
  ``Optimizer.__getstate__`` leaves it, and each index's ``lr_mult`` and
  ``wd_mult`` go into the optimizer's own ``lr_mult``/``wd_mult`` dicts,
  which the reference reads when ``param_dict`` lacks the index. The
  update counts are attributes, so they travel too.
- :func:`loads` reads that format (the reference's files and the port's
  own) and the port's pickles of torch tensors written before it: a
  ``pickle.Unpickler`` whose ``find_class`` maps jax's array
  reconstructor onto numpy, the reference's ``NDArray`` onto a holder that
  becomes a torch tensor (on the CPU: an ``Updater`` moves each state to
  its weight's device at the first update), its optimizer and scheduler
  classes onto the port's, and its ``Parameter``, ``Context`` and tape
  nodes onto inert holders; ``param_dict`` is dropped.
"""
from __future__ import annotations

import io
import pickle

import numpy as np
import torch

__all__ = ["dumps", "loads"]

_PORT = "mxnet_tpu_torch."
_REF = "mxnet_tpu."
# the reference modules whose classes a .states file may name, and the
# port's counterparts
_CLASS_MODULES = ("optimizer.optimizer", "optimizer", "lr_scheduler")


class _Ref:
    """A global of the other package, named by string."""

    def __init__(self, module, name):
        self.module, self.name = module, name

    def __call__(self, *args, **kwargs):    # a reduce tuple's callable
        raise TypeError("%s.%s is written by name only"
                        % (self.module, self.name))


_NEWOBJ = _Ref("copyreg", "__newobj__")


class _Writer(pickle._Pickler):
    """A pickler that writes :class:`_Ref` as the global it names and
    port tensors and objects as the reference's (see :func:`dumps`)."""

    dispatch = pickle._Pickler.dispatch.copy()

    def _save_ref(self, ref):
        self.write(pickle.GLOBAL + ref.module.encode("utf-8") + b"\n"
                   + ref.name.encode("utf-8") + b"\n")
        self.memoize(ref)

    dispatch[_Ref] = _save_ref

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return _NEWOBJ, (_Ref(_REF + "ndarray.ndarray", "NDArray"),), (
                None, {"_data": _array_reduce(obj),
                       "_ctx": _CPU_CONTEXT, "_grad": None,
                       "_grad_req": "null", "_ag_node": None,
                       "_stype": "default"})
        if isinstance(obj, _Obj):
            return _NEWOBJ, (obj.cls,), obj.state
        return NotImplemented


class _Obj:
    """A reference object: its class (a :class:`_Ref`) and its state."""

    def __init__(self, cls, state):
        self.cls, self.state = cls, state


_CPU_CONTEXT = _Obj(_Ref(_REF + "context", "Context"),
                    {"device_type": "cpu", "device_id": 0})


class _Call:
    """``func(*args)`` at load time."""

    def __init__(self, func, args):
        self.func, self.args = func, args

    def __reduce__(self):
        return self.func, self.args


def _array_reduce(t):
    t = t.detach().cpu()
    asarray = _Ref("jax.numpy", "asarray")
    if t.dtype == torch.bfloat16:
        return _Call(asarray, (t.float().numpy(), "bfloat16"))
    return _Call(asarray, (t.numpy(),))


def _ref_class(obj):
    module = type(obj).__module__
    if not module.startswith(_PORT):
        raise pickle.PicklingError("a .states file cannot hold %r" % (obj,))
    return _Ref(_REF + module[len(_PORT):], type(obj).__qualname__)


def _port_object(obj):
    """An optimizer or scheduler as a reference object: its pickled state,
    with the per-index multipliers of its ``param_dict`` moved into its
    ``lr_mult``/``wd_mult`` and ``param_dict`` empty."""
    state = dict(obj.__getstate__() or {})
    params = getattr(obj, "param_dict", None) or {}
    if "lr_mult" in state:
        state["lr_mult"] = dict(state["lr_mult"])
        state["wd_mult"] = dict(state["wd_mult"])
        for index, param in params.items():
            state["lr_mult"][index] = float(param.lr_mult)
            state["wd_mult"][index] = float(param.wd_mult)
        state["param_dict"] = {}
    return _Obj(_ref_class(obj), {k: _convert_out(v)
                                  for k, v in state.items()})


def _convert_out(v):
    if isinstance(v, torch.Tensor) or v is None or \
            isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, tuple):
        return tuple(_convert_out(x) for x in v)
    if isinstance(v, list):
        return [_convert_out(x) for x in v]
    if isinstance(v, dict):
        return {k: _convert_out(x) for k, x in v.items()}
    return _port_object(v)


def dumps(states, optimizer=None):
    """The reference's ``Updater.get_states`` bytes for ``states`` (and
    ``optimizer`` when given, as ``dump_optimizer`` writes it)."""
    obj = _convert_out(states)
    if optimizer is not None:
        obj = (obj, _port_object(optimizer))
    buf = io.BytesIO()
    _Writer(buf, protocol=2).dump(obj)
    return buf.getvalue()


# ---- reading ---------------------------------------------------------------


class _RefNDArray:
    """The reference's ``NDArray`` while unpickling: keeps its data."""

    def __setstate__(self, state):
        slots = state[1] if isinstance(state, tuple) else state
        self.data = slots["_data"]


class _Inert:
    """A reference ``Parameter``, ``Context`` or tape node: dropped."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _Array:
    """``jax.numpy.asarray``'s arguments: a numpy array and a dtype."""

    def __init__(self, a, dtype=None, *args, **kwargs):
        self.a, self.dtype = np.asarray(a), dtype


def _rebuild_jax_array(fun, args, arr_state, aval_state=None, *rest):
    """``jax._src.array._reconstruct_array`` on numpy alone."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return _Array(value)


class _Reader(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("jax._src.array", "_reconstruct_array"):
            return _rebuild_jax_array
        if (module, name) in (("jax.numpy", "asarray"),
                              ("jax.numpy", "array")):
            return _Array
        if module.startswith(_REF):
            sub = module[len(_REF):]
            if (sub, name) == ("ndarray.ndarray", "NDArray"):
                return _RefNDArray
            if sub in ("gluon.parameter", "context", "_tape"):
                return _Inert
            if sub in _CLASS_MODULES:
                import importlib
                return getattr(importlib.import_module(_PORT + sub), name)
        if module.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"):
            raise pickle.UnpicklingError(
                "a .states file names %s.%s, which the port does not read"
                % (module, name))
        return super().find_class(module, name)


def _to_tensor(arr):
    a = arr.a
    name = arr.dtype if isinstance(arr.dtype, str) else a.dtype.name
    if name == "bfloat16":
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _convert_in(v):
    if isinstance(v, _RefNDArray):
        data = v.data
        return _to_tensor(data if isinstance(data, _Array) else _Array(data))
    if isinstance(v, tuple):
        return tuple(_convert_in(x) for x in v)
    if isinstance(v, list):
        return [_convert_in(x) for x in v]
    if isinstance(v, dict):
        return {k: _convert_in(x) for k, x in v.items()}
    if hasattr(v, "param_dict"):
        v.param_dict = {}
    return v


def loads(data):
    """:func:`dumps`' format (the reference's files too), or the port's
    older pickles of torch tensors, as port objects and torch tensors."""
    return _convert_in(_Reader(io.BytesIO(data)).load())
