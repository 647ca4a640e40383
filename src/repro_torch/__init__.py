"""PyTorch / CUDA port of the Dynamic Repartitioning system (``repro``).

The port runs the paper's DR loop — route, bucketize, exchange, merge,
histogram, KIP repartition, migrate — on one device with W stacked
workers; the routing kernels are hand-written CUDA for Hopper
(:mod:`repro_torch.kernels`), each beside its plain PyTorch version.
Entry point: :class:`repro_torch.core.streaming.StreamingJob`.

Nothing here imports ``jax`` or the reference package ``repro``.
"""
