"""Dense linear operators.

Counterpart of ``lanczos_adjoints_tpu/ops/dense.py``. The JAX package
pins ``precision="highest"`` because a TPU multiplies in bfloat16 by
default; on the card the analogue is TF32, which ``pin_float32`` turns
off and the matvec checks.
"""

import torch

from lanczos_adjoints_tpu_torch.utils.precision import requires_float32


def dense_operator():
    """Construct ``matvec(v, matrix) -> matrix @ v`` in full float32 (or wider)."""

    @requires_float32
    def matvec(v, matrix):
        return torch.matmul(matrix, v)

    return matvec
