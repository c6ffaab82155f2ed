"""charon_tpu_torch — the PyTorch/CUDA port of the charon_tpu device plane.

The JAX package (`charon_tpu`) is the reference this package is held
against byte for byte; this package imports none of it, nor JAX. The first
slice is the fused sigagg slot: parse and G2 decompression, the windowed
Lagrange sweep and combine, affine serialization, the combined sig+pk RLC
MSMs and their reduction, the host fold, and a native multi-pairing verify.
Every device step runs on hand-written CUDA kernels for Hopper
(`ops/csrc/plane_kernels.cu`), bound through ctypes in `ops/cuda_plane.py`.

Package layout:
  crypto/    own copies of the BLS12-381 host primitives the slice needs
  native.py  ctypes loader for native/libbls12381.so (pairing, hash-to-G2,
             key material)
  ops/       limb layout and plain versions, CUDA kernels and wrappers,
             the slot and the bulk verify (plane_agg), the H(m) cache cap
             from the environment (policy), JAX-plane <-> tensor conversion
  tbls/      TorchImpl, the whole tbls backend
  dkg/       FROST keygen, its batched generator multiplications and share
             checks on the card
  utils/     own copies of the reference's errors
"""
