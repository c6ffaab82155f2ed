"""Cluster key-share topology — who holds which share of which DV; the
port's copy of charon_tpu/core/keyshares.py.

Derived from the cluster lock (reference builds these maps in app wiring,
app/app.go:339-383): for each distributed validator, the DV root public key
plus the n share public keys (1-indexed by operator), and this node's own
share index and secrets (secrets only in test/vmock contexts).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import tbls
from ..utils import errors
from .types import PubKey, pubkey_from_bytes


@dataclass
class KeyShares:
    """Share topology for one node of the cluster."""

    my_share_idx: int                                  # 1-indexed operator idx
    threshold: int
    # DV root pubkey -> share_idx -> share public key.
    share_pubkeys: dict[PubKey, dict[int, tbls.PublicKey]] = field(default_factory=dict)
    # This node's share secrets (held by its VC; present in vmock/test setups).
    my_share_secrets: dict[PubKey, tbls.PrivateKey] = field(default_factory=dict)
    # Lookup caches, built ONCE at load (__post_init__): share maps are
    # static for a run, and at mainnet scale (100k registered validators)
    # any per-call list() or linear scan on the duty/submit hot path turns
    # the serving pipeline quadratic in cluster size (the reference's
    # tests/test_loadgen.py::test_keyshares_lookup_scales).
    _roots: tuple[PubKey, ...] = field(
        default=(), init=False, repr=False, compare=False)
    _num_shares: int = field(default=0, init=False, repr=False, compare=False)
    _root_by_share: dict[bytes, PubKey] = field(
        default_factory=dict, init=False, repr=False, compare=False)
    _my_shares: tuple[bytes, ...] = field(
        default=(), init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        self.reindex()

    @classmethod
    def from_bytes(cls, my_share_idx: int, threshold: int,
                   share_pubkeys: dict, my_share_secrets: dict | None = None,
                   ) -> "KeyShares":
        """From plain bytes maps: DV root pubkey (48 bytes, or the core
        "0x" hex form) -> share index -> share pubkey bytes, and this
        node's share secrets by the same root keys."""
        def root(pk) -> PubKey:
            return pk if isinstance(pk, str) else pubkey_from_bytes(pk)

        return cls(
            my_share_idx=my_share_idx, threshold=threshold,
            share_pubkeys={root(r): {int(i): tbls.PublicKey(bytes(pk))
                                     for i, pk in shares.items()}
                           for r, shares in share_pubkeys.items()},
            my_share_secrets={root(r): tbls.PrivateKey(bytes(sk))
                              for r, sk in (my_share_secrets or {}).items()})

    def reindex(self) -> None:
        """(Re)build the O(1) lookup caches. No production flow mutates
        `share_pubkeys` after load, but a test fixture that hand-edits the
        maps in place must call this to keep the caches coherent."""
        self._roots = tuple(self.share_pubkeys)
        self._num_shares = (len(next(iter(self.share_pubkeys.values())))
                            if self.share_pubkeys else 0)
        root_by_share: dict[bytes, PubKey] = {}
        my_shares: list[bytes] = []
        for root, shares in self.share_pubkeys.items():
            mine = shares.get(self.my_share_idx)
            if mine is not None:
                b = bytes(mine)
                root_by_share[b] = root
                my_shares.append(b)
        self._root_by_share = root_by_share
        self._my_shares = tuple(my_shares)

    @property
    def root_pubkeys(self) -> tuple[PubKey, ...]:
        return self._roots

    @property
    def my_share_pubkeys(self) -> tuple[bytes, ...]:
        """This node's share pubkeys as bytes, ordered like root_pubkeys."""
        return self._my_shares

    @property
    def num_shares(self) -> int:
        return self._num_shares

    def my_share_pubkey(self, root: PubKey) -> tbls.PublicKey:
        return self.share_pubkey(root, self.my_share_idx)

    def share_pubkey(self, root: PubKey, share_idx: int) -> tbls.PublicKey:
        shares = self.share_pubkeys.get(root)
        if shares is None or share_idx not in shares:
            raise errors.new("unknown share", pubkey=root[:10], share_idx=share_idx)
        return shares[share_idx]

    def root_by_share_pubkey(self, share_pk: bytes) -> PubKey:
        """Map a VC's share pubkey back to the DV root
        (reference validatorapi.go:978-1005 pubkey mapping). O(1) via the
        precomputed reverse index — the linear scan this replaces was
        O(validators) per lookup and collapsed the duty pipeline at
        2000 DVs (every duties call is O(N) lookups, so the pipeline was
        quadratic in cluster size)."""
        root = self._root_by_share.get(bytes(share_pk))
        if root is None:
            raise errors.new("unknown share pubkey",
                             share=bytes(share_pk)[:8].hex())
        return root


def new_cluster_for_t(num_validators: int, threshold: int, num_nodes: int,
                      ) -> tuple[list[tbls.PrivateKey], list[KeyShares]]:
    """Test helper (reference cluster.NewForT): generates DV root keys, splits
    them, and returns per-node KeyShares views. Returns (root_secrets, nodes)."""
    root_secrets: list[tbls.PrivateKey] = []
    share_pubkeys: dict[PubKey, dict[int, tbls.PublicKey]] = {}
    share_secrets: dict[PubKey, dict[int, tbls.PrivateKey]] = {}
    for _ in range(num_validators):
        secret = tbls.generate_secret_key()
        root_pk = pubkey_from_bytes(tbls.secret_to_public_key(secret))
        shares = tbls.threshold_split(secret, num_nodes, threshold)
        root_secrets.append(secret)
        share_pubkeys[root_pk] = {
            i: tbls.secret_to_public_key(s) for i, s in shares.items()}
        share_secrets[root_pk] = shares
    nodes = []
    for node_idx in range(1, num_nodes + 1):
        nodes.append(KeyShares(
            my_share_idx=node_idx,
            threshold=threshold,
            share_pubkeys={r: dict(s) for r, s in share_pubkeys.items()},
            my_share_secrets={r: share_secrets[r][node_idx] for r in share_pubkeys},
        ))
    return root_secrets, nodes
