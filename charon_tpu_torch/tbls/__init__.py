"""tbls — the port's threshold-BLS facade with a pluggable backend, its own
copy of charon_tpu/tbls/__init__.py's seam (reference tbls/tbls.go:11-76):
module-level functions delegate to a swappable global Implementation, so
the duty pipeline (core/) does not know which backend runs.

The default backend is `TorchImpl()` on cuda:0 (tbls/torch_impl.py), made
at the first call that needs a backend. Without CUDA that call raises: the
facade never picks the CPU by itself. A caller that wants the CPU installs
a backend explicitly, as the tests do:

    from charon_tpu_torch import tbls
    from charon_tpu_torch.tbls.torch_impl import TorchImpl
    tbls.set_implementation(TorchImpl(device="cpu", verify="native"))
"""

from __future__ import annotations

import concurrent.futures as _cf
import threading
from typing import Protocol

import numpy as np

from .types import PrivateKey, PublicKey, Signature

__all__ = [
    "PrivateKey",
    "PublicKey",
    "Signature",
    "set_implementation",
    "get_implementation",
    "generate_secret_key",
    "secret_to_public_key",
    "threshold_split",
    "recover_secret",
    "threshold_aggregate",
    "threshold_aggregate_batch",
    "threshold_aggregate_verify_batch",
    "threshold_aggregate_verify_overlapped",
    "threshold_aggregate_verify_submit",
    "pin_pubkeys",
    "sign",
    "verify",
    "verify_batch",
    "verify_batch_each",
    "aggregate",
    "verify_aggregate",
]


class Implementation(Protocol):
    """The tbls backend seam (reference tbls/tbls.go:28-69)."""

    name: str

    def generate_secret_key(self) -> PrivateKey: ...
    def secret_to_public_key(self, secret: PrivateKey) -> PublicKey: ...
    def threshold_split(self, secret: PrivateKey, total: int, threshold: int) -> dict[int, PrivateKey]: ...
    def recover_secret(self, shares: dict[int, PrivateKey], total: int, threshold: int) -> PrivateKey: ...
    def threshold_aggregate(self, partial_sigs: dict[int, Signature]) -> Signature: ...
    def sign(self, private_key: PrivateKey, data: bytes) -> Signature: ...
    def verify(self, public_key: PublicKey, data: bytes, signature: Signature) -> bool: ...
    def aggregate(self, sigs: list[Signature]) -> Signature: ...
    def verify_aggregate(self, public_keys: list[PublicKey], data: bytes, signature: Signature) -> bool: ...
    def verify_batch(self, public_keys: list[PublicKey], datas: list[bytes], signatures: list[Signature]) -> bool: ...
    def verify_batch_each(self, public_keys: list[PublicKey], datas: list[bytes],
                          signatures: list[Signature]) -> np.ndarray: ...
    def threshold_aggregate_batch(self, batches: list[dict[int, Signature]]) -> list[Signature]: ...

    def threshold_aggregate_verify_batch(
            self, batches: list[dict[int, Signature]],
            public_keys: list[PublicKey],
            datas: list[bytes]) -> tuple[list[Signature], bool]:
        """Fused sigagg hot path: aggregate each batch, then verify every
        aggregate against (public_key, data) (reference
        core/sigagg/sigagg.go:144,159).

        PRECONDITION: every partial signature in `batches` must already be
        individually verified (and therefore subgroup-checked) — parsigex
        does this on receipt, matching the reference's trust boundary. The
        fused slot relies on it: it skips the subgroup checks of the
        partials and the aggregates, so unverified partials here would void
        the RLC soundness bound. For unverified inputs use verify_batch or
        verify per item first."""
        ...


_lock = threading.Lock()
_impl: Implementation | None = None


def _default() -> Implementation:
    """The default backend: TorchImpl() on cuda:0, made once. Raises when
    CUDA is absent (no CPU fallback)."""
    global _impl
    with _lock:
        if _impl is None:
            from .torch_impl import TorchImpl

            _impl = TorchImpl()
    return _impl


def set_implementation(impl: Implementation) -> None:
    """Swap the global backend (reference tbls/tbls.go:72 SetImplementation)."""
    global _impl
    with _lock:
        _impl = impl


def get_implementation() -> Implementation:
    return _impl if _impl is not None else _default()


def generate_secret_key() -> PrivateKey:
    return get_implementation().generate_secret_key()


def secret_to_public_key(secret: PrivateKey) -> PublicKey:
    return get_implementation().secret_to_public_key(secret)


def threshold_split(secret: PrivateKey, total: int, threshold: int) -> dict[int, PrivateKey]:
    return get_implementation().threshold_split(secret, total, threshold)


def recover_secret(shares: dict[int, PrivateKey], total: int, threshold: int) -> PrivateKey:
    return get_implementation().recover_secret(shares, total, threshold)


def threshold_aggregate(partial_sigs: dict[int, Signature]) -> Signature:
    return get_implementation().threshold_aggregate(partial_sigs)


def threshold_aggregate_batch(batches: list[dict[int, Signature]]) -> list[Signature]:
    return get_implementation().threshold_aggregate_batch(batches)


def sign(private_key: PrivateKey, data: bytes) -> Signature:
    return get_implementation().sign(private_key, data)


def verify(public_key: PublicKey, data: bytes, signature: Signature) -> bool:
    return get_implementation().verify(public_key, data, signature)


def verify_batch(public_keys: list[PublicKey], datas: list[bytes], signatures: list[Signature]) -> bool:
    return get_implementation().verify_batch(public_keys, datas, signatures)


def verify_batch_each(public_keys: list[PublicKey], datas: list[bytes],
                      signatures: list[Signature]) -> np.ndarray:
    """Per-item validity of (pk, data, sig) triples as a bool array, the
    attribution after a failed verify_batch (TorchImpl answers in one
    device call)."""
    return get_implementation().verify_batch_each(public_keys, datas, signatures)


def threshold_aggregate_verify_batch(
        batches: list[dict[int, Signature]], public_keys: list[PublicKey],
        datas: list[bytes]) -> tuple[list[Signature], bool]:
    return get_implementation().threshold_aggregate_verify_batch(
        batches, public_keys, datas)


def threshold_aggregate_verify_overlapped(
        batches: list[dict[int, Signature]], public_keys: list[PublicKey],
        datas: list[bytes]) -> tuple[list[Signature], bool]:
    """threshold_aggregate_verify_batch through the backend's own
    overlapped call when it has one (TorchImpl: the device's slot thread);
    the serial call otherwise. Same results and trust precondition."""
    impl = get_implementation()
    fn = getattr(impl, "threshold_aggregate_verify_overlapped", None)
    if fn is None:
        return impl.threshold_aggregate_verify_batch(
            batches, public_keys, datas)
    return fn(batches, public_keys, datas)


def threshold_aggregate_verify_submit(
        batches: list[dict[int, Signature]], public_keys: list[PublicKey],
        datas: list[bytes]) -> _cf.Future:
    """Future-returning threshold_aggregate_verify: a
    concurrent.futures.Future of (aggregates, ok). TorchImpl queues the
    slot on the device's slot thread and returns at once, so the calling
    thread is free while the slot runs; a backend without a submit call
    runs the serial call inline and hands back a resolved Future. Every
    error, input validation included, arrives through the Future."""
    impl = get_implementation()
    fn = getattr(impl, "threshold_aggregate_verify_submit", None)
    if fn is not None:
        return fn(batches, public_keys, datas)
    fut: _cf.Future = _cf.Future()
    try:
        fut.set_result(threshold_aggregate_verify_overlapped(
            batches, public_keys, datas))
    except Exception as exc:  # noqa: BLE001 — the Future carries the error
        fut.set_exception(exc)
    return fut


def pin_pubkeys(public_keys: list[PublicKey]) -> None:
    """Declare a pubkey set long-lived (the cluster's own share and root
    sets, fixed at DKG time): TorchImpl pins its decoded planes against
    eviction; a backend without a pk cache ignores it."""
    impl = get_implementation()
    fn = getattr(impl, "pin_pubkeys", None)
    if fn is not None:
        fn(public_keys)


def aggregate(sigs: list[Signature]) -> Signature:
    return get_implementation().aggregate(sigs)


def verify_aggregate(public_keys: list[PublicKey], data: bytes, signature: Signature) -> bool:
    return get_implementation().verify_aggregate(public_keys, data, signature)
