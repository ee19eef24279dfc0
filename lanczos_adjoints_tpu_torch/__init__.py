"""lanczos_adjoints_tpu_torch: the PyTorch and CUDA port of lanczos_adjoints_tpu.

A second package beside the JAX one, for one NVIDIA H100. It keeps the
JAX package's layout, names and conventions (a matvec is ``(v, *params)
-> Av``; functions return ``(value, info)``; each closed-form adjoint is a
``torch.autograd.Function``) and imports nothing of it. This slice holds
the Gaussian-process marginal-likelihood training step:

- ``ops``:     the fused Gram matvec (CUDA kernels K1 and K2 with plain
               PyTorch versions) and the Gram matvec policies.
- ``krylov``:  blocked Lanczos with its closed-form adjoints.
- ``solvers``: adaptive (P)CG with an implicit-differentiation backward pass.
- ``precond``: blocked pivoted partial Cholesky and the Woodbury solve.
- ``trace``:   Rademacher probes and the blocked SLQ log-determinant.
- ``models``:  GP kernels, likelihood and log-pdf backends.
- ``train``:   the GP training step (Adam with non-finite steps skipped).
- ``utils``:   float32 pinning and the synthetic dataset.
"""

__version__ = "0.1.0"
