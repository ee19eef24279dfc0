"""Plain PyTorch reference of a Lanczos forward + VJP on a DIA operator; it imports nothing of the port.

The operator is rebuilt from the configuration's COO matrix: diagonal k is
stored row-aligned, slot ``[k, i]`` holding ``A[i, i + offsets[k]]``, and
``(A v)[i] = sum_k vals[k, i] v[(i + offsets[k]) mod n]``. Lanczos without
re-orthogonalisation from ``v0 / |v0|`` (``matvec`` says in which layout
the values are differentiated): ``alpha_k = x_k . A x_k``, ``r =
A x_k - alpha_k x_k - beta_{k-1} x_{k-1}``, ``beta_k = |r|``, ``x_{k+1} =
r / beta_k``; it returns the basis ``x_0..x_{K-1}``, the diagonals, the
off-diagonals ``beta_0..beta_{K-2}``, and ``(x_K, beta_{K-1})``. The
gradients in ``v0`` and the values come from backpropagation through that
recurrence (not the closed-form adjoint), in float64. ``dtype`` may be
lowered for the control (bfloat16 for the configuration's float32).
"""

import numpy as np
import torch

from portbench.yardstick import compare as measures
from portbench.yardstick import data


def dia_from_coo(rows, cols, vals, n, *, dtype, device):
    offsets = np.unique(cols - rows)
    slots = np.zeros((len(offsets), n))
    slots[np.searchsorted(offsets, cols - rows), rows] = vals
    return [int(d) for d in offsets], torch.tensor(slots, dtype=dtype, device=device)


def matvec(offsets, vals, v):
    """``A v`` by the transpose of the stored layout: slot ``[k, j]`` carries
    ``v[j]`` into row ``j + offsets[k]``. For the symmetric operator this is
    ``A v`` entry for entry; differentiated, it gives the values' gradient in
    the convention of the closed-form adjoint of a symmetric operator, whose
    slot ``[k, i]`` is ``sum_s x_s[i] lam_s[i + offsets[k]]``."""
    out = torch.zeros_like(v)
    for k, d in enumerate(offsets):
        out = out + torch.roll(vals[k] * v, d)
    return out


def forward(offsets, vals, v0, depth):
    x = v0 / torch.linalg.vector_norm(v0)
    x_prev = torch.zeros_like(x)
    beta = torch.zeros((), dtype=x.dtype, device=x.device)
    xs, alphas, betas = [x], [], []
    for _ in range(depth):
        ax = matvec(offsets, vals, x)
        alpha = torch.dot(x, ax)
        resid = ax - alpha * x - beta * x_prev
        beta = torch.linalg.vector_norm(resid)
        x_prev, x = x, resid / beta
        xs.append(x)
        alphas.append(alpha)
        betas.append(beta)
    basis = torch.stack(xs[:-1])
    betas = torch.stack(betas)
    return [basis, torch.stack(alphas), betas[:-1], xs[-1], betas[-1]]


def vjp(offsets, vals, v0, cot, depth, dtype):
    """Forward outputs and ``(dv0, dvals)`` in ``dtype``."""
    vals = vals.to(dtype).requires_grad_()
    v0 = v0.to(dtype).requires_grad_()
    outputs = forward(offsets, vals, v0, depth)
    grads = torch.autograd.grad(outputs, [v0, vals], [c.to(dtype) for c in cot])
    return [o.detach() for o in outputs], [g.detach() for g in grads]


def gaps(outputs, grads, ref_outputs, ref_grads) -> dict:
    """The compared numbers: each a max |gap| over the reference's max |entry|."""
    basis = torch.cat([outputs[0], outputs[3][None]])
    ref_basis = torch.cat([ref_outputs[0], ref_outputs[3][None]])
    offdiag = torch.cat([outputs[2], outputs[4][None]])
    ref_offdiag = torch.cat([ref_outputs[2], ref_outputs[4][None]])
    return {
        "basis": measures.rel_max(basis, ref_basis),
        "diagonals": measures.rel_max(outputs[1], ref_outputs[1]),
        "offdiagonals": measures.rel_max(offdiag, ref_offdiag),
        "grad_v0": measures.rel_max(grads[0], ref_grads[0]),
        "grad_values": measures.rel_max(grads[1], ref_grads[1]),
    }


def operator(config, device, dtype=torch.float64):
    if config["operator"] != "laplacian_2d":
        msg = f"operator {config['operator']!r}"
        raise ValueError(msg)
    rows, cols, vals = data.laplacian_2d_coo(config["grid"])
    return dia_from_coo(rows, cols, vals, config["grid"] ** 2, dtype=dtype, device=device)


def reference(config, traffic, handoff, device, *, dtype=torch.float64):
    """``{pool entry: (outputs, grads)}`` for every pool entry of a kept request."""
    offsets, vals = operator(config, device)
    refs = {}
    for p, _outputs, _grads in handoff["kept"].values():
        if p not in refs:
            v0, cot = handoff["pool"][p]
            refs[p] = vjp(offsets, vals, v0, cot, config["depth"], dtype)
    return refs


def judge(config, got, refs, handoff):
    """``(numbers, [])``: the widest gap of each number over the kept requests of ``got``."""
    numbers = {}
    for p, outputs, grads in got["kept"].values():
        for name, gap in gaps(outputs, grads, *refs[p]).items():
            numbers[name] = max(numbers.get(name, 0.0), gap)
    return numbers, []


def compare(config, traffic, seed, handoff, device):
    return judge(config, handoff, reference(config, traffic, handoff, device), handoff)


def control(config, traffic, seed, handoff, device, ref):
    """The control's numbers: the reference in bfloat16 in the program's place."""
    low = reference(config, traffic, handoff, device, dtype=torch.bfloat16)
    return judge(config, {"kept": {p: (p, *low[p]) for p in low}}, ref, handoff)[0]
