"""EF21-Muon in PyTorch for one NVIDIA H100 (the port of ``repro``).

Same subpackage layout and names as the JAX package, PyTorch inside:
plain functions on tensors, parameters as dicts of tensors, an explicit
``device`` everywhere, ``torch.Generator``s for randomness. The
Newton-Schulz LMO runs in hand-written CUDA kernels (``kernels/``).
"""
