"""Op backends: ``ref`` (pure-jnp oracle) and ``cuda`` (``ref`` with the
Jacobi sweeps in the CUDA kernel of ops/jacobi_cuda.py).

Use :func:`cudafluidsimulation_tpu.ops.backend.get_ops` to resolve a backend.
"""
