"""repro_torch — the PyTorch/CUDA port of :mod:`repro` for one NVIDIA H100.

The package mirrors the JAX package's module tree, slice by slice.  This
slice serves a chain bank of dense transformers: the models, the
request-level engines (:class:`~repro_torch.cluster.decode.DecodeEngine`,
:class:`~repro_torch.cluster.paged.PagedDecodeEngine`) and the two decode
kernels, written in CUDA C++ for ``sm_90a``.

It imports ``torch``, numpy and the standard library only — never ``jax``
and nothing of ``repro``.  Entry points run on ``device="cuda"`` unless the
caller passes ``device="cpu"``; on a CUDA tensor a decode step is the
hand-written kernel, on a CPU tensor its plain PyTorch version.
"""
