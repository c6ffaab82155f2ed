"""Device plane of the port: limb layout and plain versions (field, curve),
the CUDA kernels and their wrappers (cuda_plane), the fused sigagg slot
(plane_agg) and the JAX-plane conversion (convert)."""
