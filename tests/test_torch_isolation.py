"""The PyTorch port stands alone: no JAX and no charon_tpu module is imported
by charon_tpu_torch (its DKG too) or chip_smoke.py, and its entry points
never pick a device on their own."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from charon_tpu_torch.ops import cuda_plane as CP
from charon_tpu_torch.tbls.torch_impl import TorchImpl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "charon_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "charon_tpu"
            or name.startswith("charon_tpu."))


_SUBPROCESS = r"""
import pkgutil, importlib, random, sys
import charon_tpu_torch
for m in pkgutil.walk_packages(charon_tpu_torch.__path__, "charon_tpu_torch."):
    importlib.import_module(m.name)
import torch
torch.set_num_threads(1)
from charon_tpu_torch import native
from charon_tpu_torch.crypto import fields as PF
from charon_tpu_torch.tbls.torch_impl import TorchImpl
import ctypes
lib = native.load_library()
rng = random.Random(4)
batches, pks, msgs = [], [], []
for v in range(4):
    sk = rng.randrange(1, PF.R)
    coeffs = [sk] + [rng.randrange(PF.R) for _ in range(3)]
    shares = {i: sum(c * i ** k for k, c in enumerate(coeffs)) % PF.R for i in range(1, 7)}
    out = (ctypes.c_uint8 * 48)(); lib.ct_pubkey(sk.to_bytes(32, "big"), out); pks.append(bytes(out))
    msg = bytes([v % 2]) * 32
    b = {}
    for i in sorted(rng.sample(range(1, 7), 4)):
        s = (ctypes.c_uint8 * 96)(); lib.ct_sign(shares[i].to_bytes(32, "big"), msg, 32, s)
        b[i] = bytes(s)
    batches.append(b); msgs.append(msg)
aggs, ok = TorchImpl(device="cpu", verify="native").threshold_aggregate_verify_batch(
    batches, pks, msgs)
assert ok and len(aggs) == 4
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "charon_tpu" or m.startswith("charon_tpu."))
print("FORBIDDEN", bad)
"""


def test_port_process_never_loads_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _SUBPROCESS], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


# the modules of the tbls backend, each imported on its own in order, then
# its bulk verify and its submit front door driven in the same process
BACKEND_MODULES = ("charon_tpu_torch.native", "charon_tpu_torch.ops.policy",
                   "charon_tpu_torch.ops.plane_agg", "charon_tpu_torch.tbls.scalar",
                   "charon_tpu_torch.tbls.torch_impl", "charon_tpu_torch.utils.errors",
                   "charon_tpu_torch.dkg.frost")

_BACKEND = r"""
import importlib, json, random, sys
def forbidden():
    return sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                  or m == "charon_tpu" or m.startswith("charon_tpu."))
seen = {}
for name in BACKEND_MODULES:
    importlib.import_module(name)
    seen[name] = forbidden()
import torch
torch.set_num_threads(1)
from charon_tpu_torch import native
from charon_tpu_torch.crypto import fields as PF
from charon_tpu_torch.tbls.torch_impl import TorchImpl
rng = random.Random(5)
sks = [rng.randrange(1, PF.R).to_bytes(32, "big") for _ in range(2)]
msgs = [b"\x01" * 32, b"\x02" * 32]
impl = TorchImpl(device="cpu", verify="native")
ok = impl.verify_batch([native.pubkey(k) for k in sks], msgs,
                       [native.sign(k, m) for k, m in zip(sks, msgs)])
coeffs = [rng.randrange(1, PF.R), rng.randrange(PF.R)]
share = {i: (coeffs[0] + coeffs[1] * i) % PF.R for i in (1, 2)}
batch = {i: native.sign(s.to_bytes(32, "big"), msgs[0]) for i, s in share.items()}
aggs, ok2 = impl.threshold_aggregate_verify_submit(
    [batch], [native.pubkey(coeffs[0].to_bytes(32, "big"))], msgs[:1]).result(timeout=300)
from charon_tpu_torch.dkg import frost
frost.DEVICE_KEYGEN, frost._DEVICE_MIN_KEYGEN, frost._DEVICE_MIN_POINTS = True, 0, 0
rounds = [frost.Participant(i, 2, 2, b"ctx").round1(device="cpu") for i in (1, 2)]
frost.verify_shares_batch([(1, s[1], b.commitments) for b, s in rounds], device="cpu")
ok3 = frost.MSM_PATHS["device"] == 2
seen["runtime"] = forbidden()
print("RESULT", json.dumps({"ok": [ok, ok2, ok3], "seen": seen}))
""".replace("BACKEND_MODULES", repr(BACKEND_MODULES))


@pytest.fixture(scope="module")
def backend_imports():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _BACKEND], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("module", BACKEND_MODULES + ("runtime",))
def test_backend_modules_load_no_jax(backend_imports, module):
    """Each module of the tbls backend and of the DKG loads neither jax nor
    charon_tpu when it is imported, directly or transitively, and neither
    does a bulk verify, a slot through the submit front door and a FROST
    round with device keygen and the device share check ("runtime"), which
    verify True."""
    assert backend_imports["ok"] == [True, True, True]
    assert backend_imports["seen"][module] == []


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_sources_import_no_jax(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_torchimpl_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: TorchImpl() is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchImpl()
    assert TorchImpl(device="cpu").device.type == "cpu"


def test_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(1, 12, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        CP.fe_mul(a.to(torch.int64), a.to(torch.int64), 1)
    with pytest.raises(ValueError):
        CP.fe_add(a, torch.zeros(1, 12, 16, dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        CP.fe_sub(a, a, 2)
    strided = torch.zeros(2, 12, 16, dtype=torch.int32)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        CP.fe_mul(strided, strided, 2)
    with pytest.raises(ValueError):
        CP.pt_double(*(torch.zeros(1, 12, 8, dtype=torch.int32, device="meta"),) * 3, 1)
