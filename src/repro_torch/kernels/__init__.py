"""Hand-written Hopper kernels of the port (pair: ``repro/kernels/``).

K1 ``quantize.int8_roundtrip_rows`` (CUDA C++, ``csrc/int8_roundtrip.cu``)
replaces ``repro/kernels/quantize.py:32``. Each kernel has its plain
PyTorch version in ``ref.py``.
"""
