"""ctypes loader for the C identity-profile interner (interner.c), the JAX
package's native/pyintern.py.

Built at first use with the running interpreter's headers (native.
build_library: into the package's _build/, keyed on the source, the flags
and the interpreter's version, published atomically) and loaded with
ctypes.PyDLL — NOT CDLL: every exported function manipulates Python
objects, so the GIL must stay held across calls, and PyDLL raises the
pending Python exception after a call that set one.  Python symbols are
left undefined in the .so and resolve against the process at dlopen time.

Unlike the JAX package's loader, a failed build or load raises (with the
compiler's output): a SpecInterner never drops to the Python loop because
the library is missing.
"""

from __future__ import annotations

import ctypes
import sys
import sysconfig
import threading

from . import _DIR, build_library

SRC = _DIR / "interner.c"
_LOCK = threading.Lock()
_lib = None


def _flags():
    return ("-O2", "-fPIC", "-shared", f"-I{sysconfig.get_paths()['include']}")


def load() -> ctypes.PyDLL:
    """The loaded library, building it first if needed."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.PyDLL(str(build_library(SRC, "gcc", _flags(), key=sys.version.encode())))
            lib.interner_new.restype = ctypes.c_void_p
            lib.interner_new.argtypes = []
            lib.interner_free.restype = None
            lib.interner_free.argtypes = [ctypes.c_void_p]
            lib.interner_clear.restype = None
            lib.interner_clear.argtypes = [ctypes.c_void_p]
            lib.interner_count.restype = ctypes.c_int64
            lib.interner_count.argtypes = [ctypes.c_void_p]
            lib.interner_prov.restype = ctypes.c_int64
            lib.interner_prov.argtypes = [ctypes.c_void_p]
            lib.interner_forced.restype = ctypes.c_int64
            lib.interner_forced.argtypes = [ctypes.c_void_p]
            lib.interner_lookup.restype = ctypes.c_int64
            lib.interner_lookup.argtypes = [
                ctypes.c_void_p, ctypes.py_object,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.interner_insert.restype = ctypes.c_int
            lib.interner_insert.argtypes = [
                ctypes.c_void_p, ctypes.py_object,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.interner_canonicalize.restype = ctypes.c_int64
            lib.interner_canonicalize.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            _lib = lib
    return _lib
