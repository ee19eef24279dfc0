"""lanczos_adjoints_tpu_torch: the PyTorch and CUDA port of lanczos_adjoints_tpu.

A second package beside the JAX one, for one NVIDIA H100. It keeps the
JAX package's layout, names and conventions (a matvec is ``(v, *params)
-> Av``; functions return ``(value, info)``; each closed-form adjoint is a
``torch.autograd.Function``) and imports nothing of it. It holds the
Gaussian-process marginal-likelihood training step and the sparse
Lanczos forward + adjoint VJP on a DIA operator:

- ``ops``:     the fused Gram matvec (CUDA kernels K1 and K2) and the Gram
               matvec policies; CSR/DIA sparse operators with the DIA
               matvec (K4, K5) and the fused DIA Lanczos forward and
               adjoint (K6, K7); each kernel with its plain PyTorch version.
- ``krylov``:  single-vector and blocked Lanczos with their closed-form
               adjoints, and the dispatch of DIA operators to K6/K7.
- ``solvers``: adaptive (P)CG with an implicit-differentiation backward pass.
- ``precond``: pivoted partial Cholesky (sequential, blocked) and the
               Woodbury solve.
- ``trace``:   Rademacher probes and the blocked SLQ log-determinant.
- ``models``:  GP kernels, likelihood and log-pdf backends.
- ``parallel``: operators row-partitioned over a mesh of partitions on
               one card, with the halo-exchange DIA matvec (K11).
- ``train``:   the GP training step (Adam with non-finite steps skipped),
               also over a mesh.
- ``utils``:   float32 pinning, the synthetic dataset, the in-repo
               Laplacian and timing on the card.
- ``studies``: the paper's studies (loss of orthogonality, VJP wall
               times against backprop, the Gram VJP, the MLL, the Gram
               matvec policies) on the card.
"""

__version__ = "0.1.0"
