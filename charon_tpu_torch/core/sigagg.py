"""SigAgg — stateless threshold aggregation (reference core/sigagg/sigagg.go);
the port's copy of charon_tpu/core/sigagg.py.

Per validator: Lagrange-combine `threshold` matching partials into the root
signature (sigagg.go:89-151, tbls.ThresholdAggregate at :144), inject it into
the SignedData, then verify the aggregate against the DV root public key
(sigagg.go:159, NewVerifier:167). All validators of the duty aggregate and
verify in ONE fused tbls call (threshold_aggregate_verify_submit: TorchImpl's
slot on the card) — the primary device call of the whole pipeline
(north-star sigagg config: 100-1000 validators per slot batch).
"""

from __future__ import annotations

import asyncio

from .. import tbls
from ..eth2.spec import ChainSpec
from ..utils import errors, log, metrics, tracer
from .keyshares import KeyShares
from .signeddata import _Eth2Signed
from .types import Duty, ParSignedData, PubKey, SignedDataSet, pubkey_to_bytes

_log = log.with_topic("sigagg")

_agg_hist = metrics.histogram(
    "core_sigagg_duration_seconds", "Threshold aggregation latency", ("duty",))


class SigAgg:
    """reference sigagg.New / Aggregate (sigagg.go:48)."""

    def __init__(self, keys: KeyShares, chain: ChainSpec, verify: bool = True,
                 coalescer=None):
        self._keys = keys
        self._chain = chain
        self._verify = verify
        # optional cross-duty batching window (core/coalesce.py): routes the
        # fused aggregate+verify through a shared dispatch so concurrent
        # duties of a small cluster still reach the device batch threshold
        self._coalescer = coalescer
        self._subs = []
        # The cluster's pubkey sets are fixed for the run (the share⇄root
        # maps come from the cluster lock), so declare them long-lived up
        # front: TorchImpl pins the decoded planes of the sigagg root set
        # and of each per-peer share set (the parsigex verify shape)
        # against cache eviction; a backend without a pk cache ignores it
        # (tbls.pin_pubkeys).
        if keys.root_pubkeys:
            tbls.pin_pubkeys([pubkey_to_bytes(pk) for pk in keys.root_pubkeys])
            for idx in range(1, keys.num_shares + 1):
                share_set = [bytes(shares[idx]) for shares
                             in keys.share_pubkeys.values() if idx in shares]
                if share_set:
                    tbls.pin_pubkeys(share_set)

    def subscribe(self, fn) -> None:
        self._subs.append(fn)

    async def aggregate(self, duty: Duty,
                        parsigs: dict[PubKey, list[ParSignedData]]) -> None:
        """Aggregate threshold partials for all validators of the duty in one
        batched device call, verify, and emit the SignedDataSet."""
        if not parsigs:
            return
        threshold = self._keys.threshold

        batches: list[dict[int, tbls.Signature]] = []
        pubkeys: list[PubKey] = []
        templates: list[ParSignedData] = []
        for pubkey, sigs in parsigs.items():
            if len(sigs) < threshold:
                raise errors.new("insufficient partial signatures",
                                 duty=str(duty), got=len(sigs), need=threshold)
            chosen = sorted(sigs, key=lambda p: p.share_idx)[:threshold]
            batches.append({p.share_idx: p.signature() for p in chosen})
            pubkeys.append(pubkey)
            templates.append(chosen[0])

        # signing roots are independent of the signature, so they can be
        # computed up front — enabling the fused aggregate+verify device
        # pass when every item in the batch is verifiable
        all_eth2 = self._verify and all(
            isinstance(t.data, _Eth2Signed) for t in templates)

        if all_eth2:
            pk_bytes = [pubkey_to_bytes(pk) for pk in pubkeys]
            roots = [t.data.signing_root(self._chain) for t in templates]
            if self._coalescer is not None:
                # the coalescer records its own window-wait and fused-flush
                # metrics (core_coalesce_*); timing the shared multi-duty
                # dispatch under THIS duty's histogram label would corrupt
                # the per-duty latency series
                with tracer.start_span("sigagg/aggregate+verify",
                                       duty=str(duty), batch=len(batches)):
                    agg_sigs, ok = await self._coalescer.aggregate_verify(
                        batches, pk_bytes, roots)
            else:
                with _agg_hist.time(str(duty.type)), \
                        tracer.start_span("sigagg/aggregate+verify",
                                          duty=str(duty), batch=len(batches)):
                    # the submit front door runs the fused slot on the
                    # device's slot thread, keeping the event loop free
                    # while the device works
                    agg_sigs, ok = await asyncio.wrap_future(
                        tbls.threshold_aggregate_verify_submit(
                            batches, pk_bytes, roots))
        else:
            with _agg_hist.time(str(duty.type)), \
                    tracer.start_span("sigagg/aggregate", duty=str(duty),
                                      batch=len(batches)):
                agg_sigs = await asyncio.get_running_loop().run_in_executor(
                    None, tbls.threshold_aggregate_batch, batches)

        signed: SignedDataSet = {}
        verify_pks: list[tbls.PublicKey] = []
        verify_roots: list[bytes] = []
        for pubkey, template, agg in zip(pubkeys, templates, agg_sigs):
            data = template.data.set_signature(agg)
            signed[pubkey] = data
            if not all_eth2 and self._verify and isinstance(data, _Eth2Signed):
                verify_pks.append(pubkey_to_bytes(pubkey))
                verify_roots.append(data.signing_root(self._chain))

        loop = asyncio.get_running_loop()
        if verify_pks:
            verify_sigs = [signed[pk].signature() for pk in pubkeys
                           if isinstance(signed[pk], _Eth2Signed)]
            ok = await loop.run_in_executor(
                None, tbls.verify_batch, verify_pks, verify_roots, verify_sigs)
        if verify_pks or all_eth2:
            if not ok:
                # Identify the failing aggregate individually.
                for pubkey in pubkeys:
                    data = signed[pubkey]
                    if isinstance(data, _Eth2Signed) and not await \
                            loop.run_in_executor(None, data.verify,
                                                 self._chain,
                                                 pubkey_to_bytes(pubkey)):
                        raise errors.new("aggregate signature verification failed",
                                         duty=str(duty), pubkey=pubkey[:10])
                raise errors.new("batch aggregate verification failed", duty=str(duty))

        _log.debug("aggregated threshold signatures", duty=str(duty),
                   validators=len(signed))
        for fn in self._subs:
            await fn(duty, {k: v.clone() for k, v in signed.items()})
