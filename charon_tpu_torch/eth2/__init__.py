"""Ethereum consensus-layer utilities, the port's copies of
charon_tpu/eth2's:

  ssz.py      — SSZ serialization + hash_tree_root merkleization
  spec.py     — minimal consensus-spec datatypes used by the duty pipeline
  signing.py  — signing domains + signing roots (eth2util/signing/signing.go)
"""
