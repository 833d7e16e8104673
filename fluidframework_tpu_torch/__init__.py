"""fluidframework_tpu_torch: the PyTorch + CUDA port of fluidframework_tpu.

A sibling of the JAX package, written for one NVIDIA Hopper GPU. The
JAX package stays the reference: every ported function is held
against it (same inputs, bit-identical int32 outputs, same digests).

This package imports ``torch`` and numpy, never ``jax`` and nothing
of ``fluidframework_tpu``; where it needs a jax-free helper from the
JAX package it keeps its own copy, and says so at the top of the
copied module.

Ported so far: the overlay merge-tree replay path that ``bench.py``
measures (stream generation, the per-chunk overlay kernel as a
hand-written CUDA kernel for sm_90a, the settle-merge fold, the fold
log, and the host readout + digest), many documents per launch, the
row-model chunk replay (the second hand-written kernel), the host op
encoder with the message-driven overlay replica, the summary
service's fold-and-emit datapath (``server/summary_fold.py``), the
deli sequencer (``server/deli_kernel.py``), and SharedTree's batched
changeset rebase (``tree/rebase_kernel.py``).

Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA device they raise instead of falling
back (see `utils.devices.resolve_device`).
"""

__version__ = "0.1.0"
