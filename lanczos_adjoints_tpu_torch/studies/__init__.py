"""The paper's studies, on the card: counterparts of ``experiments/benchmarks/``.

Each module takes its JAX script's arguments plus ``--device`` (default
``cuda``) and ``--out DIR``, and writes its files under the JAX names
and formats into ``--out``:

- ``loss_of_orthogonality``: the Arnoldi adjoint's gradient error with
  and without re-projection against backprop, on Hilbert matrices;
- ``wall_times_vjp``: the forward pass, the closed-form-adjoint VJP and
  backprop through the recurrence, each timed against Krylov depth;
- ``vjp_through_matvec``: a recompute-in-backward Gram matvec against
  autodiff through the plain one;
- ``value_and_grad_of_mll``: ``value_and_grad`` of the GP marginal
  likelihood under two Gram matvec policies;
- ``gram_matvec``: the Gram matvec policies, the fused kernel K1 among
  them, over N, with the table and the figure;
- ``mtx_parser``: the MatrixMarket loader's three parsers (scipy, the C++
  body parser of ``native``, numpy), from file to CSR, on the host.

They are the paper's studies, not a benchmark of the port.
"""
