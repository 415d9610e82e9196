"""Hopper kernels for EF21-Muon's compute hot spot, each with its plain
PyTorch version in ``ref.py``.

  * ``newton_schulz``: the quintic NS iteration (Muon's spectral LMO) as
    CUDA C++ kernels (``csrc/newton_schulz.cu``), built at first use by
    ``build.py``;
  * ``ops``: the entry points the optimizer calls.
"""
