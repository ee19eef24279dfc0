"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W).

Frozen copies of ``chip_smoke.py``'s ``PEAK_FLOPS_FP32``, ``PEAK_BYTES`` and
``PEAK_FLOPS_3XTF32``. Every roofline and ``mfu`` share of the benchmark is
stated against these, with the card's power limit printed beside it.
"""

# fp32 on the CUDA cores (not the tensor cores).
PEAK_FLOPS_FP32 = 67e12
# HBM3 bandwidth.
PEAK_BYTES = 3.35e12
# The dense TF32 tensor-core rate over the three products of a 3xTF32
# (fp32-accurate) contraction.
PEAK_FLOPS_3XTF32 = 495e12 / 3
