"""Hand-written Hopper kernels of the port (pair: ``repro/kernels/``).

Each is CUDA C++ (``csrc/*.cu``, built by ``nvcc.py`` at first use) with
its plain PyTorch version in ``ref.py``:
  K1 ``quantize.int8_roundtrip_rows`` replaces ``repro/kernels/quantize.py:32``;
  K2 ``dcor.pairwise_dist`` (forward, backward) replaces ``repro/kernels/dcor.py:28``;
  K3 ``fused_xent.fused_xent`` (forward, backward) replaces
     ``repro/kernels/fused_xent.py:62``;
  K4 ``flash_attention.flash_attention`` (forward, backward) replaces
     ``repro/kernels/flash_attention.py:75``.
"""
