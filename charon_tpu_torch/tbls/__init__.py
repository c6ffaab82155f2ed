"""tbls-seam entry points of the port (TorchImpl)."""
