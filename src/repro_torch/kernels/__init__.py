"""Hopper kernels of EF21-Muon, each with its plain PyTorch version
beside it (``ref.py``, or the ``*_ref`` functions of its module).

  * ``newton_schulz``: the quintic NS iteration (Muon's spectral LMO) as
    CUDA C++ kernels (``csrc/newton_schulz.cu``);
  * ``bitpack``: the wire's narrow-index and 1-bit packing kernels
    (``csrc/bitpack.cu``);
  * ``natural_pack``: Natural compression's encode (``csrc/natural_pack.cu``);
  * ``ops``: the entry points the optimizer and compressors call.

``build.py`` compiles each ``csrc/*.cu`` at first use.
"""
