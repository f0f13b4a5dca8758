"""PyTorch + CUDA port of ``pipegcn_tpu`` for one NVIDIA H100.

The JAX package ``pipegcn_tpu`` stays the reference; this package mirrors
its module names so each port module's counterpart is easy to find, and
imports nothing of it (nor of ``jax``). Slice 1 ports the serving path:
host artifact -> staging + use_pp precompute -> sharded-eval refresh ->
owner-gather query. Slice 2 ports the training main path
(``scripts/reddit.sh``: pipelined full-graph GraphSAGE over P parts
stacked on one card, ``cli/main.py`` -> ``parallel/trainer.py``). The
device kernels on both paths are written by hand for Hopper
(``ops/csrc/spmm_mean.cu``: mean SpMM and its transpose;
``ops/csrc/halo_gather.cu``: halo gather and reverse-ring return;
``ops/csrc/halo_scatter.cu``: boundary-gradient scatter).

Every entry point takes an explicit device (``device.resolve_device``):
CUDA unless the caller asks for ``"cpu"``, never a silent fallback.
"""
