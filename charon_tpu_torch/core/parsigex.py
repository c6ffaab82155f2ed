"""ParSigEx — partial-signature exchange between peers
(reference core/parsigex/parsigex.go); the port's copy of
charon_tpu/core/parsigex.py.

Direct n² broadcast to all peers — latency over bandwidth
(docs/architecture.md:544-549). Inbound partials pass the duty gater then
**every partial signature is verified** against its share public key before
acceptance (parsigex.go:61-102) — the bulk-verification hot path that
TorchImpl.verify_batch runs on the card (north-star parsigex config: 500
DVs, mixed duties).

MemTransport here is the in-memory test fabric (reference
parsigex/memory.go).
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable

from .. import tbls
from ..eth2.spec import ChainSpec
from ..utils import aio, errors, faults, log, metrics
from .gater import DutyGaterFunc
from .keyshares import KeyShares
from .signeddata import _Eth2Signed
from .types import Duty, ParSignedData, ParSignedDataSet, PubKey

_log = log.with_topic("parsigex")

_recv_counter = metrics.counter(
    "core_parsigex_received_total",
    "Partials received from peers, by handling result "
    "(verified / verify_failed / unknown_duty / fault)", ("result",))

VerifyFunc = Callable[[Duty, PubKey, ParSignedData], Awaitable[None]]


def new_eth2_verifier(chain: ChainSpec, keys: KeyShares) -> VerifyFunc:
    """Verify a peer's partial sig against that share's public key
    (reference parsigex.go:139 NewEth2Verifier)."""

    async def verify(duty: Duty, pubkey: PubKey, psd: ParSignedData) -> None:
        data = psd.data
        if not isinstance(data, _Eth2Signed):
            raise errors.new("unverifiable partial data type",
                             kind=type(data).__name__)
        share_pk = keys.share_pubkey(pubkey, psd.share_idx)
        # pairing check runs ~ms in the native library: hop off the loop
        loop = asyncio.get_running_loop()
        ok = await loop.run_in_executor(None, data.verify, chain, share_pk)
        if not ok:
            raise errors.new("invalid partial signature", duty=str(duty),
                             pubkey=pubkey[:10], share_idx=psd.share_idx)

    return verify


def new_batch_eth2_verifier(chain: ChainSpec, keys: KeyShares,
                            coalescer=None):
    """Batched variant: verify a whole inbound set in one tbls.verify_batch
    call (the device fast path); falls back to per-sig verify to identify
    culprits on failure (north-star parsigex batching). With a coalescer
    (core/coalesce.py), inbound sets from several peers landing within the
    batching window share one fused device dispatch."""

    async def verify_set(duty: Duty, parsigs: ParSignedDataSet) -> None:
        pks: list[tbls.PublicKey] = []
        roots: list[bytes] = []
        sigs: list[tbls.Signature] = []
        for pubkey, psd in parsigs.items():
            data = psd.data
            if not isinstance(data, _Eth2Signed):
                raise errors.new("unverifiable partial data type",
                                 kind=type(data).__name__)
            pks.append(keys.share_pubkey(pubkey, psd.share_idx))
            roots.append(data.signing_root(chain))
            sigs.append(psd.signature())
        if coalescer is not None:
            # each of the n−1 other peers broadcasts one set per duty —
            # declaring that lets the window close as soon as the full
            # contributor group has arrived (adaptive close-on-quorum);
            # the sender's share index identifies the contributor so a
            # retransmitted set can't fake quorum
            sender = next(iter(parsigs.values())).share_idx
            if await coalescer.verify(pks, roots, sigs, key=duty,
                                      expected=keys.num_shares - 1,
                                      contributor=sender):
                return
        else:
            # batch pairing work blocks for ~ms in the backend: hop off
            # the loop so concurrent duties keep flowing
            loop = asyncio.get_running_loop()
            if await loop.run_in_executor(None, tbls.verify_batch,
                                          pks, roots, sigs):
                return
        # Batch failed: identify culprit(s) individually.
        loop = asyncio.get_running_loop()
        for (pubkey, psd), pk, root, sig in zip(parsigs.items(), pks, roots, sigs):
            if not await loop.run_in_executor(None, tbls.verify, pk, root, sig):
                raise errors.new("invalid partial signature", duty=str(duty),
                                 pubkey=pubkey[:10], share_idx=psd.share_idx)
        # Batch verify failed but every signature passed individually: the
        # batch and individual verifiers disagree. Surface it loudly instead
        # of silently accepting a set no effective check validated.
        raise errors.new("batch/individual signature verifier disagreement",
                         duty=str(duty), count=len(sigs))

    return verify_set


class ParSigEx:
    """Peer partial-sig exchange over a pluggable transport
    (reference parsigex.go:105 Broadcast, :61 handle)."""

    def __init__(self, transport, peer_idx: int, gater: DutyGaterFunc,
                 verify_set=None, retryer=None):
        self._transport = transport
        self._peer_idx = peer_idx
        self._gater = gater
        self._verify_set = verify_set
        self._retryer = retryer  # utils.retry.Retryer or None (no retry)
        self._subs = []
        transport.register(peer_idx, self._handle)

    def subscribe(self, fn) -> None:
        self._subs.append(fn)

    async def broadcast(self, duty: Duty, parsigs: ParSignedDataSet) -> None:
        """Send our partials to every peer directly (parsigex.go:105-130).
        With a Retryer wired (app.assemble passes the duty-deadline one),
        temporary transport failures re-send under backoff until the
        duty's deadline — a peer blip must not lose our partials; without
        one the legacy single-attempt shape is unchanged."""
        if self._retryer is None:
            await self._transport.broadcast(self._peer_idx, duty, parsigs)
            return
        await self._retryer.do_async(
            duty, "parsigex broadcast",
            lambda: self._transport.broadcast(self._peer_idx, duty, parsigs))

    async def _handle(self, duty: Duty, parsigs: ParSignedDataSet) -> None:
        """Inbound from a peer: gate, verify every partial, then hand to
        subscribers (ParSigDB.StoreExternal) (parsigex.go:61-102)."""
        try:
            faults.check("parsigex.recv")
        except Exception as exc:  # noqa: BLE001 — injected chaos only
            _recv_counter.inc("fault", amount=len(parsigs))
            _log.warn("dropping peer partials: injected recv fault",
                      err=exc, duty=str(duty))
            return
        if not self._gater(duty):
            _recv_counter.inc("unknown_duty", amount=len(parsigs))
            _log.warn("dropping gated duty from peer", duty=str(duty))
            return
        if self._verify_set is not None:
            try:
                await self._verify_set(duty, parsigs)
            except Exception as exc:  # noqa: BLE001 — invalid peer data dropped
                _recv_counter.inc("verify_failed", amount=len(parsigs))
                _log.warn("dropping invalid peer partials", err=exc, duty=str(duty))
                return
        _recv_counter.inc("verified", amount=len(parsigs))
        for fn in self._subs:
            await fn(duty, {k: v.clone() for k, v in parsigs.items()})


class MemTransport:
    """In-memory n-node fabric for tests (reference core/parsigex/memory.go
    NewMemTransport): broadcast delivers to every *other* registered node."""

    def __init__(self):
        self._handlers: dict[int, Callable] = {}

    def register(self, peer_idx: int, handler) -> None:
        self._handlers[peer_idx] = handler

    async def broadcast(self, from_idx: int, duty: Duty,
                        parsigs: ParSignedDataSet) -> None:
        # Fire-and-forget like the reference's SendAsync (p2p/sender.go:107):
        # the sender never blocks on peers' verification work.
        for idx, handler in list(self._handlers.items()):
            if idx == from_idx:
                continue
            aio.spawn(handler(duty, {k: v.clone() for k, v in parsigs.items()}),
                      name=f"parsigex-deliver-{idx}")
