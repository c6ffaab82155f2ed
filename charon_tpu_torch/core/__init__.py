"""The duty pipeline's signing back half, the port's copy of the
reference's core/ components from a peer's partial signature to the
aggregate:

  ParSigEx (verify every inbound partial) → ParSigDB —(threshold)→ SigAgg
  → AggSigDB

with the cross-duty coalescer (coalesce.py) batching the verifies and the
slots of concurrent duties into single device calls through the port's
tbls facade.
"""

from .types import (  # noqa: F401
    Duty,
    DutyType,
    ParSignedData,
    ParSignedDataSet,
    PubKey,
    SignedDataSet,
    pubkey_from_bytes,
    pubkey_to_bytes,
)
