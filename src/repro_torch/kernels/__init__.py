"""Hand-written CUDA kernels for the port's routing hot path, each beside
its plain PyTorch version (:mod:`repro_torch.kernels.ref`).

* :mod:`~repro_torch.kernels.lookup_dispatch` — partition lookup + lane slot.
* :mod:`~repro_torch.kernels.route_bucketize` — the same plus the scatter
  into the send buffers.
* :mod:`~repro_torch.kernels.ops` — the padding/sentinel wrappers the
  exchange plane calls.
* :mod:`~repro_torch.kernels.build` — compiles ``csrc/*.cu`` at first use.
"""
