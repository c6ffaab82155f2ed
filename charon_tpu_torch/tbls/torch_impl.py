"""TorchImpl: the port's tbls-seam entry points for the fused sigagg slot.

Same method names and return types as the reference's TPUImpl
(charon_tpu/tbls/tpu_impl.py): threshold_aggregate,
threshold_aggregate_batch and threshold_aggregate_verify_batch. Every batch
size goes to the device (there is no small-batch routing and no fallback):
device errors propagate.

The device is explicit. `TorchImpl()` runs on cuda:0 and raises when CUDA is
absent; only `TorchImpl(device="cpu")` selects the plain versions of the
kernels, which is what the CPU tests pass.

The slot verifies on the device by default (`verify="device"`: H(m) and the
multi-pairing on the rows kernels, as the reference's default device
verify); `verify="native"` selects the native ct_pairing_check rung
explicitly. Neither falls back to the other.
"""

from __future__ import annotations

import torch

from ..ops import plane_agg as PA
from .types import Signature


class TorchImpl:
    """tbls implementation running the fused slot on one CUDA device."""

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
        self.verify = verify
        self.h2c = PA.H2CCache()
        # pairs checked per rung (the reference's ops_pairing_total{path})
        self.pairing_path: dict[str, int] = {p: 0 for p in PA.VERIFY_PATHS}
        self.last_times = PA.SlotTimes()

    @staticmethod
    def _raw(batches) -> list[dict[int, bytes]]:
        for b in batches:
            if not b:
                raise ValueError("no partial signatures to aggregate")
        return [{i: bytes(s) for i, s in b.items()} for b in batches]

    def threshold_aggregate(self, partial_sigs: dict[int, bytes]) -> Signature:
        return self.threshold_aggregate_batch([partial_sigs])[0]

    def threshold_aggregate_batch(self, batches: list[dict[int, bytes]]) -> list[Signature]:
        if not batches:
            return []
        raw = PA.aggregate(PA.layout_slots(self._raw(batches)), self.device)
        return [Signature(r) for r in raw]

    def threshold_aggregate_verify_batch(self, batches, public_keys, datas):
        """Fused slot: the aggregates plus one RLC verdict over all of them."""
        n = len(batches)
        if not (n == len(public_keys) == len(datas)):
            raise ValueError("length mismatch")
        raw, ok = PA.threshold_aggregate_and_verify(
            self._raw(batches), [bytes(pk) for pk in public_keys],
            [bytes(d) for d in datas], self.device, self.pk_cache, self.h2c,
            self.pairing_path, times=self.last_times, verify=self.verify)
        return [Signature(r) for r in raw], ok
