"""ctypes loader for the repo's native BLS12-381 library (native/).

The port's verify step calls the native multi-pairing (`ct_pairing_check`)
and hash-to-G2 (`ct_hash_to_g2`); TorchImpl's key-material calls go through
`ct_pubkey`, `ct_sign`, `ct_verify`, `ct_aggregate_g1` and `ct_aggregate_g2`,
as the reference's NativeImpl does (charon_tpu/tbls/native_impl.py:131-227).
The native slot rung of ops/guard.py (`native_slot_fallback`) runs
`ct_lincomb_g2` and `ct_verify_batch`; `chip_smoke.py` also builds its
inputs and oracles with them and `ct_g2_check`. The port's FROST
(dkg/frost.py) checks its commitments through `ct_g1_lincomb` (its native rung, as the
reference's frost.py:59-64), and `ct_g1_check` is the G1 oracle. Only those symbols are declared, with
the reference's argtypes (native_impl.py:37-75). Like the reference loader,
`load_library()` first runs `make -C native` (a no-op when the library is
fresh) and then the library's selftest.
"""

from __future__ import annotations

import concurrent.futures as futures
import ctypes
import os
import subprocess
import sys
import threading

from .crypto import fields as PF

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libbls12381.so")

_P = ctypes.c_void_p
_S = ctypes.c_char_p
_N = ctypes.c_size_t

# name -> (argtypes, restype): pointers as c_void_p / c_char_p, sizes as
# c_size_t, so no argument is narrowed to a 32-bit c_int.
_SIG = {
    "ct_selftest": ([], ctypes.c_int),
    "ct_pairing_check": ([_S, _S, _S, _N, ctypes.c_int], ctypes.c_int),
    "ct_hash_to_g2": ([_S, _N, _P], ctypes.c_int),
    "ct_pubkey": ([_S, _P], ctypes.c_int),
    "ct_sign": ([_S, _S, _N, _P], ctypes.c_int),
    "ct_verify": ([_S, _S, _N, _S], ctypes.c_int),
    "ct_aggregate_g2": ([_S, _N, _P], ctypes.c_int),
    "ct_aggregate_g1": ([_S, _N, _P], ctypes.c_int),
    "ct_lincomb_g2": ([_S, _S, _N, _P], ctypes.c_int),
    "ct_verify_batch": ([_S, _S, ctypes.POINTER(ctypes.c_uint64), _S, _S, _N], ctypes.c_int),
    "ct_g2_check": ([_S], ctypes.c_int),
    "ct_g1_check": ([_S], ctypes.c_int),
    "ct_g1_lincomb": ([_S, _S, _N, _P], ctypes.c_int),
}

_lock = threading.Lock()
_lib: list = []
_pool_lock = threading.Lock()
_pool: list = []
# the native slot rung's verify chunk: at least this many triples a
# ct_verify_batch call
MIN_VERIFY_CHUNK = 64


def host_pool() -> futures.ThreadPoolExecutor:
    """The native slot rung's threads, one a CPU core: the library's calls
    release the interpreter lock and touch no shared state."""
    with _pool_lock:
        if not _pool:
            _pool.append(futures.ThreadPoolExecutor(max_workers=os.cpu_count() or 1,
                                                    thread_name_prefix="native-rung"))
        return _pool[0]


def load_library() -> ctypes.CDLL:
    """Build (when stale), load, declare and selftest the native library.
    Raises subprocess.CalledProcessError / OSError when it cannot be built,
    loaded or passes no selftest: the calls that use it have no other
    path."""
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
        if lib.ct_selftest() != 1:
            raise OSError("native selftest failed")
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


def pubkey(secret: bytes) -> bytes:
    """The compressed G1 public key of a 32-byte secret scalar."""
    out = (ctypes.c_uint8 * 48)()
    load_library().ct_pubkey(bytes(secret), out)
    return bytes(out)


def sign(secret: bytes, data: bytes) -> bytes:
    """The compressed signature [secret]·H(data)."""
    out = (ctypes.c_uint8 * 96)()
    load_library().ct_sign(bytes(secret), data, len(data), out)
    return bytes(out)


def verify(pk: bytes, data: bytes, sig: bytes) -> bool:
    """One signature, with the native decoders' curve, subgroup and
    infinity checks: False on any invalid input."""
    return load_library().ct_verify(bytes(pk), data, len(data), bytes(sig)) == 1


def aggregate_g2(sigs: list[bytes]) -> bytes | None:
    """The sum of compressed G2 points; None when one does not decode."""
    out = (ctypes.c_uint8 * 96)()
    rc = load_library().ct_aggregate_g2(b"".join(bytes(s) for s in sigs), len(sigs), out)
    return bytes(out) if rc == 0 else None


def aggregate_g1(pks: list[bytes]) -> bytes | None:
    """The sum of compressed G1 points; None when one does not decode."""
    out = (ctypes.c_uint8 * 48)()
    rc = load_library().ct_aggregate_g1(b"".join(bytes(p) for p in pks), len(pks), out)
    return bytes(out) if rc == 0 else None


def lincomb_g2(sigs: list[bytes], scalars: list[int]) -> bytes | None:
    """Σ (kᵢ mod r)·Sᵢ over compressed G2 points (ct_lincomb_g2),
    compressed; None when a point does not decode."""
    out = (ctypes.c_uint8 * 96)()
    rc = load_library().ct_lincomb_g2(
        b"".join(bytes(s) for s in sigs),
        b"".join((k % PF.R).to_bytes(32, "big") for k in scalars), len(sigs), out)
    return bytes(out) if rc == 0 else None


def _aggregate_one(batch: dict[int, bytes]) -> bytes:
    if not batch:
        raise ValueError("no partial signatures to aggregate")
    ids = sorted(batch)
    out = lincomb_g2([batch[i] for i in ids], PF.lagrange_coefficients_at_zero(ids))
    if out is None:
        raise ValueError("invalid partial signature encoding")
    return out


def threshold_aggregate(batches: list[dict[int, bytes]]) -> list[bytes]:
    """Each batch's aggregate Σ λⱼ·sigⱼ on the host (NativeImpl's
    threshold_aggregate): Lagrange coefficients at 0 over Fr and one
    ct_lincomb_g2 a batch, the batches spread over `host_pool()`. Raises
    the reference's ValueErrors, the first batch's in order: "no partial
    signatures to aggregate", "invalid partial signature encoding"."""
    return list(host_pool().map(_aggregate_one, batches))


def verify_batch_chunked(pks: list[bytes], msgs: list[bytes], sigs: list[bytes]) -> bool:
    """RLC batch verify of (pk, msg, sig) triples under fresh CSPRNG
    randomizers: one ct_verify_batch a chunk of the triples (a chunk a
    host_pool() thread, at least MIN_VERIFY_CHUNK triples each), True iff
    every chunk verifies. Each chunk is an RLC check of its own, so the
    verdict is ct_verify_batch's over all of them, with the same 2^-64
    soundness a chunk."""
    from .crypto.rlc import sample_randomizer

    n = len(sigs)
    if n == 0:
        return True
    step = max(MIN_VERIFY_CHUNK, -(-n // (os.cpu_count() or 1)))
    spans = [(s, min(s + step, n)) for s in range(0, n, step)]
    return all(host_pool().map(
        lambda se: verify_batch(pks[se[0]:se[1]], msgs[se[0]:se[1]], sigs[se[0]:se[1]],
                                [sample_randomizer() for _ in range(se[1] - se[0])]), spans))


def native_slot_fallback(batches: list[dict[int, bytes]], pks: list[bytes],
                         msgs: list[bytes]) -> tuple[list[bytes], bool]:
    """The slot on the host, the last rung of ops/guard.py (the reference's
    tbls/native_impl.py native_slot_fallback): `threshold_aggregate`, then
    the RLC verify of the aggregates (`verify_batch_chunked`). Returns
    (compressed aggregates, all_valid), byte-identical to the device slot
    and to the reference's rung; a length mismatch raises ValueError. The
    reference runs both steps on one thread; this rung spreads them over
    the host's cores, so that a 1000-validator slot fits a duty's 12 s."""
    if not batches:
        return [], True
    aggs = threshold_aggregate(batches)
    if not (len(pks) == len(msgs) == len(aggs)):
        raise ValueError("length mismatch")
    return aggs, verify_batch_chunked(pks, msgs, aggs)


def verify_batch(pks: list[bytes], msgs: list[bytes], sigs: list[bytes],
                 coefs: list[int]) -> bool:
    """Native RLC batch verify (ct_verify_batch) with the given nonzero
    randomizers, each below 2^128."""
    n = len(pks)
    offs = (ctypes.c_uint64 * (n + 1))()
    pos = 0
    for i, m in enumerate(msgs):
        offs[i] = pos
        pos += len(m)
    offs[n] = pos
    return load_library().ct_verify_batch(
        b"".join(bytes(p) for p in pks), b"".join(bytes(m) for m in msgs), offs,
        b"".join(bytes(s) for s in sigs), b"".join(c.to_bytes(16, "big") for c in coefs), n) == 1


def g2_check(sig: bytes) -> bool:
    """True iff the compressed G2 point decodes onto the curve and lies in
    the r-subgroup (infinity passes)."""
    return load_library().ct_g2_check(bytes(sig)) == 1


def g1_check(pk: bytes) -> bool:
    """True iff the compressed G1 point decodes onto the curve and lies in
    the r-subgroup (infinity passes)."""
    return load_library().ct_g1_check(bytes(pk)) == 1


def g1_lincomb(points: list[bytes], scalars: list[int]) -> bytes | None:
    """Σ (kᵢ mod r)·Pᵢ over compressed G1 points, compressed; None when a
    point does not decode (no subgroup check)."""
    out = (ctypes.c_uint8 * 48)()
    rc = load_library().ct_g1_lincomb(
        b"".join(bytes(p) for p in points),
        b"".join((s % PF.R).to_bytes(32, "big") for s in scalars), len(points), out)
    return bytes(out) if rc == 0 else None
