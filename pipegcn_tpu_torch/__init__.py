"""PyTorch + CUDA port of ``pipegcn_tpu`` for one NVIDIA H100.

The JAX package ``pipegcn_tpu`` stays the reference; this package mirrors
its module names so each port module's counterpart is easy to find, and
imports nothing of it (nor of ``jax``). Slice 1 ports the serving path:
host artifact -> staging + use_pp precompute -> sharded-eval refresh ->
owner-gather query, with the two device kernels on that path written by
hand for Hopper (``ops/csrc/spmm_mean.cu``, ``ops/csrc/halo_gather.cu``).

Every entry point takes an explicit device (``device.resolve_device``):
CUDA unless the caller asks for ``"cpu"``, never a silent fallback.
"""
