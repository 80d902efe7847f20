"""Serialization: pickle protocol 5, functions and classes by value, and
ObjectRef capture (the counterpart of ``ray_tpu/_private/serialization.py``;
ref: python/ray/_private/serialization.py:122 SerializationContext).

Out-of-band buffer callbacks carry large numpy arrays as raw buffers, and
ObjectRefs embedded in a value are recorded so the runtime keeps their
counts while they are in flight.

The reference pickles with cloudpickle, which the card's machine does not
have. Here ``_Pickler`` is the standard library's ``pickle.Pickler`` with a
``reducer_override`` that sends by value every function and class that
cannot be found by reference: anything defined in ``__main__``, in a local
scope, or as a lambda. A function goes as its code (``marshal``), the
globals its code names (``co_names``, through nested code objects too), its
closure cells, defaults, keyword defaults, ``__dict__`` and
``__qualname__``; a class as its metaclass, bases and class dict, with
``staticmethod``, ``classmethod`` and ``property`` unwrapped and rewrapped.
Cells, globals and class attributes are filled in after the object exists,
so recursive functions, mutually referencing closures and classes whose
methods name the class round-trip. Importable functions and classes, and
modules, go by reference.

A CUDA tensor crosses a process boundary as a host copy: pickled as it is,
it would record its device index, and that index names a different card in
a process whose ``CUDA_VISIBLE_DEVICES`` differs. Its bytes go out of band
(one copy from the card, none more in the pickle), and ``serialize`` counts
them as the wire form's ``d2h_bytes``. It arrives as a CPU tensor that owns
its bytes, or, read through ``deserialize_landing`` (a compiled graph's
shared-memory channel), straight on the reader's card, copied there from
the wire form. A CPU tensor pickles as torch pickles it and stays on the
CPU.
"""

from __future__ import annotations

import builtins
import importlib
import io
import marshal
import pickle
import sys
import threading
import types
import warnings
from typing import Any, Dict, List, Tuple

from ray_tpu_torch._private.object_ref import ObjectRef

_THREAD_LOCAL = threading.local()


class SerializedObject:
    """Pickled payload plus its out-of-band buffers and captured ObjectRefs."""

    __slots__ = ("data", "buffers", "contained_refs", "d2h_bytes")

    def __init__(self, data: bytes, buffers: List[pickle.PickleBuffer],
                 contained_refs: List[Any], d2h_bytes: int = 0):
        self.data = data
        self.buffers = buffers
        self.contained_refs = contained_refs
        #: Bytes of the CUDA tensors copied to the host for this wire form.
        self.d2h_bytes = d2h_bytes

    @property
    def flat_size(self) -> int:
        """Exact byte length of the to_bytes()/write_into() wire form."""
        return 12 + 8 * len(self.buffers) + len(self.data) + sum(
            b.raw().nbytes for b in self.buffers)

    def to_bytes(self) -> bytes:
        """Flatten into one buffer (framing: u32 count, u64 sizes, payloads)."""
        out = io.BytesIO()
        out.write(len(self.buffers).to_bytes(4, "little"))
        out.write(len(self.data).to_bytes(8, "little"))
        for b in self.buffers:
            out.write(b.raw().nbytes.to_bytes(8, "little"))
        out.write(self.data)
        for b in self.buffers:
            out.write(b.raw())
        return out.getvalue()

    def write_into(self, dest: memoryview) -> int:
        """Write the to_bytes() form straight into ``dest`` (an arena
        buffer), skipping the intermediate flat copy; returns the bytes
        written. ``dest`` must be at least ``flat_size`` long."""
        off = 0

        def put(b) -> None:
            nonlocal off
            n = len(b)
            dest[off:off + n] = b
            off += n

        put(len(self.buffers).to_bytes(4, "little"))
        put(len(self.data).to_bytes(8, "little"))
        for b in self.buffers:
            put(b.raw().nbytes.to_bytes(8, "little"))
        put(self.data)
        for b in self.buffers:
            raw = b.raw()
            put(raw.cast("B") if raw.format != "B" or raw.ndim != 1 else raw)
        return off


def _capture_ref(ref: Any) -> None:
    refs = getattr(_THREAD_LOCAL, "captured_refs", None)
    if refs is not None:
        refs.append(ref)


# ------------------------------------------------------------ by reference
def _lookup(module_name: str, qualname: str) -> Any:
    obj = sys.modules[module_name]
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _by_reference(obj: Any) -> bool:
    """Can the receiver import ``obj`` by its module and qualified name?"""
    module_name = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", None)
    if not module_name or not qualname or module_name == "__main__":
        return False
    if module_name not in sys.modules or "<" in qualname:
        return False
    try:
        return _lookup(module_name, qualname) is obj
    except AttributeError:
        return False


def _import_module(name: str) -> types.ModuleType:
    return importlib.import_module(name)


def _host_tensor(buf, dtype_name: str, shape: tuple) -> Any:
    """A CUDA tensor's host copy on the receiving side. Inside
    ``deserialize_landing`` with a CUDA device it is copied straight from
    the wire form onto that card; else it is a CPU tensor over ``buf`` where
    ``buf`` is writable (the wire form's owner stays alive with it) and a
    copy where it is not."""
    import torch

    dtype = getattr(torch, dtype_name)
    mv = memoryview(buf)
    landing = getattr(_THREAD_LOCAL, "landing", None)
    if callable(landing):
        landing = _THREAD_LOCAL.landing = landing()
    if not mv.nbytes:
        t = torch.empty(shape, dtype=dtype)
        return t if landing is None else t.to(landing)
    with warnings.catch_warnings():
        # Read only here: a read-only wire form is copied below.
        warnings.simplefilter("ignore", UserWarning)
        raw = torch.frombuffer(mv, dtype=torch.uint8)
    t = raw.view(dtype).reshape(shape)
    if landing is not None and landing.type == "cuda":
        _THREAD_LOCAL.h2d += mv.nbytes
        return t.to(landing)
    return t.clone() if mv.readonly else t


def _reduce_cuda_tensor(t: Any) -> tuple:
    host = t.detach().cpu().contiguous()
    nbytes = host.numel() * host.element_size()
    if getattr(_THREAD_LOCAL, "d2h", None) is not None:
        _THREAD_LOCAL.d2h += nbytes
    flat = host.reshape(-1).view(sys.modules["torch"].uint8).numpy()
    return _host_tensor, (pickle.PickleBuffer(flat),
                          str(host.dtype).rsplit(".", 1)[1],
                          tuple(host.shape))


# --------------------------------------------------------------- functions
def _code_global_names(code: types.CodeType) -> set:
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _code_global_names(const)
    return names


def _make_function(code_bytes: bytes, fn_globals: dict, name: str,
                   ncells: int) -> types.FunctionType:
    closure = tuple(types.CellType() for _ in range(ncells)) or None
    return types.FunctionType(marshal.loads(code_bytes), fn_globals, name,
                              None, closure)


def _set_function_state(fn: types.FunctionType, state: dict) -> None:
    fn.__globals__.update(state["globals"])
    for cell, (full, value) in zip(fn.__closure__ or (), state["cells"]):
        if full:
            cell.cell_contents = value
    fn.__defaults__ = state["defaults"]
    fn.__kwdefaults__ = state["kwdefaults"]
    fn.__qualname__ = state["qualname"]
    fn.__module__ = state["module"]
    fn.__doc__ = state["doc"]
    fn.__dict__.update(state["dict"])


def _cell_state(cell: types.CellType) -> tuple:
    try:
        return True, cell.cell_contents
    except ValueError:  # an empty cell: a name bound later in its scope
        return False, None


# ------------------------------------------------------------------ classes
#: Attributes that ``type()`` (or ``ABCMeta``) creates itself for a class.
_CLASS_SKIP = ("__dict__", "__weakref__", "_abc_impl")


def _make_class(metaclass: type, name: str, bases: tuple,
                namespace: dict) -> type:
    return metaclass(name, bases, namespace)


class _Wrapped:
    """A ``staticmethod``, ``classmethod`` or ``property`` of a class sent
    by value, as its parts (the wrappers themselves do not pickle)."""

    def __init__(self, kind: str, parts: tuple):
        self.kind = kind
        self.parts = parts

    def rewrap(self) -> Any:
        return {"staticmethod": staticmethod, "classmethod": classmethod,
                "property": property}[self.kind](*self.parts)


def _set_class_state(cls: type, state: dict) -> None:
    for key, value in state.items():
        setattr(cls, key,
                value.rewrap() if isinstance(value, _Wrapped) else value)


def _unwrap(value: Any) -> Any:
    if isinstance(value, (staticmethod, classmethod)):
        return _Wrapped(type(value).__name__, (value.__func__,))
    if isinstance(value, property):
        return _Wrapped("property", (value.fget, value.fset, value.fdel,
                                     value.__doc__))
    return value


class _Pickler(pickle.Pickler):
    """``pickle.Pickler`` that captures ObjectRefs, sends CUDA tensors as
    host copies, and sends non-importable functions and classes by value."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        #: One globals dict per source module within one pickle, so the
        #: functions of a module share it on the other side too.
        self._globals: Dict[int, dict] = {}

    def reducer_override(self, obj: Any):
        cls = type(obj)
        if cls is ObjectRef:
            _capture_ref(obj)
            return obj.__reduce__()
        if cls is types.FunctionType:
            if _by_reference(obj):
                return NotImplemented
            return self._reduce_function(obj)
        if cls is types.ModuleType:
            return _import_module, (obj.__name__,)
        if isinstance(obj, type):
            if _by_reference(obj) or obj.__module__ == "builtins":
                return NotImplemented
            return self._reduce_class(obj)
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor) \
                and obj.is_cuda:
            return _reduce_cuda_tensor(obj)
        return NotImplemented

    def _reduce_function(self, fn: types.FunctionType):
        code = fn.__code__
        src = fn.__globals__
        fn_globals = self._globals.get(id(src))
        if fn_globals is None:
            fn_globals = self._globals[id(src)] = {
                "__name__": src.get("__name__"),
                "__builtins__": builtins}
        names = _code_global_names(code)
        state = {
            "globals": {n: src[n] for n in names if n in src},
            "cells": [_cell_state(c) for c in fn.__closure__ or ()],
            "defaults": fn.__defaults__,
            "kwdefaults": fn.__kwdefaults__,
            "qualname": fn.__qualname__,
            "module": fn.__module__,
            "doc": fn.__doc__,
            "dict": dict(fn.__dict__),
        }
        args = (marshal.dumps(code), fn_globals, fn.__name__,
                len(fn.__closure__ or ()))
        return _make_function, args, state, None, None, _set_function_state

    def _reduce_class(self, cls: type):
        attrs = dict(vars(cls))
        namespace = {"__module__": cls.__module__,
                     "__qualname__": cls.__qualname__}
        slots = attrs.get("__slots__")
        if slots is not None:
            namespace["__slots__"] = slots
            for slot in ([slots] if isinstance(slots, str) else slots):
                attrs.pop(slot, None)
        for key in _CLASS_SKIP + ("__module__", "__qualname__", "__slots__"):
            attrs.pop(key, None)
        state = {k: _unwrap(v) for k, v in attrs.items()}
        args = (type(cls), cls.__name__, cls.__bases__, namespace)
        return _make_class, args, state, None, None, _set_class_state


def _pickle(value: Any, buffer_callback=None) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=5, buffer_callback=buffer_callback).dump(value)
    return buf.getvalue()


def serialize(value: Any) -> SerializedObject:
    """Pickle ``value`` with its buffers out of band, recording the
    ObjectRefs it holds."""
    buffers: List[pickle.PickleBuffer] = []
    _THREAD_LOCAL.captured_refs = []
    _THREAD_LOCAL.d2h = 0
    try:
        data = _pickle(value, buffers.append)
        return SerializedObject(data, buffers,
                                list(_THREAD_LOCAL.captured_refs),
                                _THREAD_LOCAL.d2h)
    finally:
        _THREAD_LOCAL.captured_refs = None
        _THREAD_LOCAL.d2h = None


def deserialize_flat(flat: memoryview) -> Any:
    """Inverse of SerializedObject.to_bytes, zero-copy for the buffers."""
    flat = memoryview(flat)
    nbuf = int.from_bytes(flat[:4], "little")
    ndata = int.from_bytes(flat[4:12], "little")
    sizes = [int.from_bytes(flat[12 + 8 * i:20 + 8 * i], "little")
             for i in range(nbuf)]
    off = 12 + 8 * nbuf
    data = flat[off:off + ndata]
    off += ndata
    buffers = []
    for size in sizes:
        buffers.append(flat[off:off + size])
        off += size
    return pickle.loads(data, buffers=buffers)


def deserialize_landing(flat: memoryview, device) -> Tuple[Any, int]:
    """``deserialize_flat`` with every CUDA tensor that crossed as a host
    copy landing on ``device`` (a CUDA ``torch.device``, or a function
    giving one, called at the first such tensor; None or the CPU leave them
    CPU tensors); returns the value and the bytes copied host-to-device. Arrays and tensors left on the host alias ``flat``, so
    pass a private writable copy."""
    _THREAD_LOCAL.landing, _THREAD_LOCAL.h2d = device, 0
    try:
        return deserialize_flat(flat), _THREAD_LOCAL.h2d
    finally:
        _THREAD_LOCAL.landing = None


def dumps(value: Any) -> bytes:
    """One-shot pickle (control messages, function and class exports)."""
    return _pickle(value)


#: The reference's pickle for request/reply transports, which skips its wire
#: pins (borrowing across nodes); the port has none, so it is ``dumps``.
dumps_inband = dumps


loads = pickle.loads
