"""ctypes loader for the repo's native BLS12-381 library (native/).

The port's verify step calls the native multi-pairing (`ct_pairing_check`)
and hash-to-G2 (`ct_hash_to_g2`); `chip_smoke.py` also builds its inputs and
oracle with `ct_pubkey`, `ct_sign` and `ct_lincomb_g2`. Only those symbols are
declared. Like the reference loader, `load_library()` first runs
`make -C native` (a no-op when the library is fresh).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libbls12381.so")

_P = ctypes.c_void_p
_S = ctypes.c_char_p
_N = ctypes.c_size_t

# name -> (argtypes, restype): pointers as c_void_p / c_char_p, sizes as
# c_size_t, so no argument is narrowed to a 32-bit c_int.
_SIG = {
    "ct_pairing_check": ([_S, _S, _S, _N, ctypes.c_int], ctypes.c_int),
    "ct_hash_to_g2": ([_S, _N, _P], ctypes.c_int),
    "ct_pubkey": ([_S, _P], ctypes.c_int),
    "ct_sign": ([_S, _S, _N, _P], ctypes.c_int),
    "ct_lincomb_g2": ([_S, _S, _N, _P], ctypes.c_int),
}

_lock = threading.Lock()
_lib: list = []


def load_library() -> ctypes.CDLL:
    """Build (when stale), load and declare the native library. Raises
    subprocess.CalledProcessError / OSError when it cannot be built or
    loaded: the verify step has no other path."""
    with _lock:
        if _lib:
            return _lib[0]
        subprocess.run(["make", "-C", _NATIVE_DIR, f"PYTHON={sys.executable}"],
                       check=True, capture_output=True, timeout=600)
        lib = ctypes.CDLL(_SO_PATH)
        for name, (argtypes, restype) in _SIG.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib.append(lib)
        return lib


def hash_to_g2(msg: bytes) -> bytes:
    """Compressed H(msg) through ct_hash_to_g2."""
    out = (ctypes.c_uint8 * 96)()
    load_library().ct_hash_to_g2(msg, len(msg), out)
    return bytes(out)


def pairing_check(g1_cat: bytes, g2_cat: bytes, negs: bytes) -> bool:
    """prod_i e(P_i, Q_i)^(+-1) == 1 over compressed points; subgroup
    re-checks skipped (the slot passes already-validated points)."""
    rc = load_library().ct_pairing_check(g1_cat, g2_cat, negs, len(negs), 0)
    if rc < 0:
        raise ValueError("native pairing check could not decode its inputs")
    return rc == 1
