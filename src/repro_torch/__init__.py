"""repro_torch — the PyTorch/CUDA port of :mod:`repro` for one NVIDIA H100.

The package mirrors the JAX package's module tree, slice by slice: serving
a chain bank of dense transformers (the models,
:class:`~repro_torch.cluster.decode.DecodeEngine`,
:class:`~repro_torch.cluster.paged.PagedDecodeEngine`), posterior-
predictive serving from any chain bank
(:class:`~repro_torch.cluster.serve.ServeEngine`, the predict-fn builders
of :mod:`repro_torch.models.predictive`), training them
with delayed-gradient SGLD (:mod:`repro_torch.core`,
:mod:`repro_torch.samplers`, :class:`~repro_torch.train.engine.Engine`,
:mod:`repro_torch.launch.train`), the paper's experiments (the
potentials and theory in :mod:`repro_torch.core`, the W2 and KL metrics in
:mod:`repro_torch.metrics`, the §3.2 regression and §3.3 RICA runs in
:mod:`repro_torch.experiments`), the multi-chain
:class:`~repro_torch.cluster.executor.ClusterEngine` with its faults and
self-healing (:mod:`repro_torch.faults`), checkpoints in the JAX
package's file format (:mod:`repro_torch.checkpoint`), and the tooling:
the instrumentation bus (:mod:`repro_torch.analysis`), Chrome-trace
timelines (:mod:`repro_torch.obs.timeline`), the batch prefetcher
(:class:`~repro_torch.data.pipeline.Prefetcher`), and the launch tools —
step builders, the ``meta``-device dry run with its FLOP count and the
H100 roofline (:mod:`repro_torch.launch`).  All four kernels
of the JAX package — the two decode steps, the fused Langevin update and
the W-Icon delay gather — are written in CUDA C++ for ``sm_90a``.

It imports ``torch``, numpy and the standard library only — never ``jax``
and nothing of ``repro``.  Entry points run on ``device="cuda"`` unless the
caller passes ``device="cpu"``; on a CUDA tensor each kernel op is the
hand-written kernel, on a CPU tensor its plain PyTorch version.
"""
