"""TorchImpl: the port as a whole tbls backend, behind the same seam as the
reference's TPUImpl (charon_tpu/tbls/tpu_impl.py:100-332):

    from charon_tpu import tbls
    tbls.set_implementation(TorchImpl())        # cuda:0

It has every method of the `charon_tpu.tbls.Implementation` protocol, and
`threshold_aggregate_verify_overlapped`, `threshold_aggregate_verify_submit`,
`pin_pubkeys` and `verify_batch_each`, which the facade and the duty
pipeline reach:

  * threshold_aggregate(_batch), threshold_aggregate_verify_batch: the
    fused slot (ops/plane_agg.py) on the device.
  * verify_batch: the bulk RLC verify of (pk, msg, sig) triples
    (plane_agg.rlc_verify_batch: chunks of 1,024 on the device, the G2
    subgroup check included, then the pairing on the impl's rung).
  * threshold_aggregate_verify_submit / _overlapped: the serial fused slot
    run whole on the device's slot thread (`slot_thread`), so the caller (the
    duty pipeline's event loop) is free while it runs. The reference's
    SigAggPipeline, which overlaps one slot's pack with another's finish, is
    not ported: the port's slot is host-bound, and two slots' host work at
    once share the interpreter lock and lose to one after another.
  * pin_pubkeys: pins the set's planes in this impl's pk-plane cache.
  * key material (generate_secret_key, threshold_split, recover_secret over
    Fr; secret_to_public_key, sign, verify, aggregate, verify_aggregate)
    and verify_batch_each (per-item attribution): the native library
    through the port's loader, as the reference's calls go to NativeImpl.

Every batch size goes to the device: there is no small-batch routing and
no fallback, and a device error propagates, through the call or the
future. The device is explicit. `TorchImpl()` runs on cuda:0 and raises
when CUDA is absent; only `TorchImpl(device="cpu")` selects the plain
versions of the kernels, which is what the CPU tests pass.

The slot and the bulk verify check their pairings on the device by default
(`verify="device"`: H(m) and the multi-pairing on the rows kernels, as the
reference's default device verify); `verify="native"` selects the native
ct_pairing_check rung explicitly. Neither falls back to the other. The
rung is the attribute `rung` (`verify` is the protocol's method).
"""

from __future__ import annotations

import concurrent.futures as futures
import threading

import numpy as np
import torch

from .. import native
from ..ops import plane_agg as PA
from ..ops import policy as policy_mod
from .scalar import FrScalarOps
from .types import PrivateKey, PublicKey, Signature

_SLOT_THREADS: dict[str, futures.ThreadPoolExecutor] = {}
_SLOT_THREADS_LOCK = threading.Lock()


def slot_thread(device) -> futures.ThreadPoolExecutor:
    """The device's slot thread, shared by every TorchImpl on it: submitted
    slots run on it one at a time, in submission order."""
    key = str(torch.device(device))
    with _SLOT_THREADS_LOCK:
        pool = _SLOT_THREADS.get(key)
        if pool is None:
            pool = _SLOT_THREADS[key] = futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"sigagg-slot-{key}")
        return pool


class TorchImpl(FrScalarOps):
    """tbls implementation running the device work on one CUDA device."""

    name = "torch-cuda"

    def __init__(self, device: str | torch.device | None = None, verify: str = "device"):
        if verify not in PA.VERIFY_PATHS:
            raise ValueError(f"verify must be one of {PA.VERIFY_PATHS}, got {verify!r}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("TorchImpl needs a CUDA device; pass device='cpu' "
                                   "for the plain CPU path")
            device = "cuda:0"
        self.device = torch.device(device)
        self.pk_cache = PA.PkPlaneCache()
        self.rung = verify          # the verify rung; `verify` is the protocol's method
        self.h2c = PA.H2CCache(policy_mod.h2c_cache_cap_default())
        # pairs checked per rung (the reference's ops_pairing_total{path})
        self.pairing_path: dict[str, int] = {p: 0 for p in PA.VERIFY_PATHS}
        self.last_times = PA.SlotTimes()

    @staticmethod
    def _raw(batches) -> list[dict[int, bytes]]:
        for b in batches:
            if not b:
                raise ValueError("no partial signatures to aggregate")
        return [{i: bytes(s) for i, s in b.items()} for b in batches]

    @staticmethod
    def _check_lengths(*lists) -> None:
        if len({len(x) for x in lists}) != 1:
            raise ValueError("length mismatch")

    # -- key material: Fr from FrScalarOps, curve work native -------------

    def secret_to_public_key(self, secret: PrivateKey) -> PublicKey:
        self._scalar(secret)
        return PublicKey(native.pubkey(bytes(secret)))

    def sign(self, private_key: PrivateKey, data: bytes) -> Signature:
        self._scalar(private_key)
        return Signature(native.sign(bytes(private_key), data))

    def verify(self, public_key: PublicKey, data: bytes, signature: Signature) -> bool:
        return native.verify(bytes(public_key), data, bytes(signature))

    def aggregate(self, sigs: list[Signature]) -> Signature:
        if not sigs:
            raise ValueError("no signatures to aggregate")
        out = native.aggregate_g2([bytes(s) for s in sigs])
        if out is None:
            raise ValueError("invalid signature encoding")
        return Signature(out)

    def verify_aggregate(self, public_keys: list[PublicKey], data: bytes,
                         signature: Signature) -> bool:
        """FastAggregateVerify: all keys signed the same message."""
        if not public_keys:
            return False
        pk = native.aggregate_g1([bytes(p) for p in public_keys])
        return pk is not None and self.verify(PublicKey(pk), data, signature)

    def verify_batch_each(self, public_keys: list[PublicKey], datas: list[bytes],
                          signatures: list[Signature]) -> np.ndarray:
        """Per-item validity, the attribution after a failed batch: native
        per-item verification."""
        self._check_lengths(public_keys, datas, signatures)
        return np.asarray([self.verify(pk, d, s) for pk, d, s
                           in zip(public_keys, datas, signatures)], dtype=bool)

    # -- the device paths -------------------------------------------------

    def threshold_aggregate(self, partial_sigs: dict[int, Signature]) -> Signature:
        return self.threshold_aggregate_batch([partial_sigs])[0]

    def threshold_aggregate_batch(self, batches: list[dict[int, Signature]]) -> list[Signature]:
        if not batches:
            return []
        raw = PA.aggregate(PA.layout_slots(self._raw(batches)), self.device)
        return [Signature(r) for r in raw]

    def verify_batch(self, public_keys: list[PublicKey], datas: list[bytes],
                     signatures: list[Signature]) -> bool:
        """All-or-nothing RLC batch verify on the device for every n >= 1
        (n = 0 is True): a False means at least one bad triple, including
        a bad encoding, an infinity or an out-of-subgroup point."""
        self._check_lengths(public_keys, datas, signatures)
        return PA.rlc_verify_batch(
            [bytes(p) for p in public_keys], [bytes(d) for d in datas],
            [bytes(s) for s in signatures], self.device, self.pk_cache, self.h2c,
            self.pairing_path, self.rung)

    def threshold_aggregate_verify_batch(self, batches, public_keys, datas):
        """Fused slot: the aggregates plus one RLC verdict over all of them."""
        self._check_lengths(batches, public_keys, datas)
        raw, ok = PA.threshold_aggregate_and_verify(
            self._raw(batches), [bytes(pk) for pk in public_keys],
            [bytes(d) for d in datas], self.device, self.pk_cache, self.h2c,
            self.pairing_path, times=self.last_times, verify=self.rung)
        return [Signature(r) for r in raw], ok

    def threshold_aggregate_verify_overlapped(self, batches, public_keys, datas):
        """threshold_aggregate_verify_batch on the device's slot thread, in
        order with the slots submitted before it."""
        return self.threshold_aggregate_verify_submit(batches, public_keys, datas).result()

    def threshold_aggregate_verify_submit(self, batches, public_keys, datas) -> futures.Future:
        """Queue threshold_aggregate_verify_batch on the device's slot thread
        and return its Future of (aggregates, ok) at once. Every error,
        input validation included, arrives through the Future."""
        return slot_thread(self.device).submit(self.threshold_aggregate_verify_batch,
                                               batches, public_keys, datas)

    def pin_pubkeys(self, public_keys) -> None:
        """Keep this set's pk planes (every span, bucket and device) through
        any cache pressure: the cluster's own share and root sets."""
        self.pk_cache.pin([bytes(pk) for pk in public_keys])
