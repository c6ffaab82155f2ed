"""The port's slot-shaping knob, read from the same environment variable
as the reference's (charon_tpu/ops/policy.py):

  * CHARON_TPU_H2C_CACHE_CAP, default 4096: entries of plane_agg.H2CCache
    (a value that is not an integer reads as the default; <= 0 disables
    the cache). It is read when a TorchImpl is made.

The reference's SlotPolicy seam (install / update / subscribe, epochs) is
not ported: no caller of the port installs a policy. Its other knobs are
left out with their variables: `pipeline_depth` and `finish_workers` (the
SigAggPipeline's, not ported: the port's submit front door runs the serial
slot on one thread), `field_plane` (the TPU's XLA or Pallas field plane;
the port has one set of kernels), `sigagg_devices` (the mesh clamp: the
multi-GPU slice), `breaker_threshold`, `breaker_cooldown_s` and
`slot_deadline_s` (ops/guard.py's breaker and watchdog, not ported: in the
port a device error propagates), `flush_at` and `deadline_budget_s` (the
coalescer's window) and `device_verify` (TorchImpl takes its verify rung
explicitly).
"""

from __future__ import annotations

import os

ENV_H2C_CACHE_CAP = "CHARON_TPU_H2C_CACHE_CAP"
H2C_CACHE_CAP = 4096


def h2c_cache_cap_default() -> int:
    try:
        return int(os.environ[ENV_H2C_CACHE_CAP])
    except (KeyError, ValueError):
        return H2C_CACHE_CAP
