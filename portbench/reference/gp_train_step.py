"""Plain PyTorch reference of the GP training step; it imports nothing of the port.

The semantics of the port's ``train.gp.train_step`` at the configuration:
the negative log marginal likelihood over N of a GP with a constant mean and
a scaled Matern-3/2 ARD kernel (softplus constraints, the noise above 1e-4),
with the log-determinant by blocked stochastic Lanczos quadrature (each
probe's Lanczos re-orthogonalised twice against its own basis, ``log``
with Ritz values under eps clipped to 1) and the Mahalanobis term by
adaptive PCG (``rms(r / (atol + rtol |x|)) > 1``, at least ``miniter``
steps) under a Woodbury preconditioner from a block-pivoted partial
Cholesky. Its gradient is the estimator's own: backpropagation through the
Lanczos recurrence and its eigendecomposition, and the implicit derivative
of the solve (a second PCG on the cotangent); the preconditioner gives
none. Adam as ``torch.optim.Adam``'s update.

The Gram matrix is never stored: every product with it runs over
symmetric tiles of rows, each built from the inputs, and the kernel
parameters' gradient of all the products of a step is one more pass
(``Gram.param_grads``). Squared distances in a tile come from one matrix
product of augmented rows; on a CUDA device the Matern function of a tile
is one elementwise expression (``torch.cuda.jiterator``), elsewhere the
same arithmetic in separate operations. In the parameter pass the squared
differences enter through one float64 product per tile,
``sum_ij P_ij (x_ic - x_jc)^2 = sum_i (x_ic^2 (P 1)_i - 2 x_ic (P x_c)_i
+ (P x_c^2)_i)``, exact sums of the float32 entries of ``P``.
``precision="tf32"`` rounds the operands of every matrix product to TF32
(10 mantissa bits, round to nearest), the control that the comparison
must fail.
"""

import math

import torch

from portbench.yardstick import compare as measures

EPS32 = float(torch.finfo(torch.float32).eps)
NOISE_MIN = 1e-4


def round_tf32(x):
    """The nearest TF32 value of each float32 entry (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -8192).view(torch.float32)


class Precision:
    def __init__(self, name):
        if name not in ("float32", "tf32"):
            msg = f"precision {name!r}"
            raise ValueError(msg)
        self.tf32 = name == "tf32"

    def mm(self, a, b):
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b

    def einsum(self, eq, *ops):
        if self.tf32:
            ops = [round_tf32(o) for o in ops]
        return torch.einsum(eq, *ops)


def softplus(x):
    return torch.nn.functional.softplus(x, beta=1.0, threshold=20.0)


MATERN = "template <typename T> T matern(T r, T eps) { T d = sqrt(r > eps ? r : eps); return (T(1) + d) * exp(-d); }"
MATERN_PARTS = (
    "template <typename T> void parts(T m, T r, T eps, T& p, T& q) "
    "{ T d = sqrt(r > eps ? r : eps); T e = exp(-d); p = m * e; q = m * ((T(1) + d) * e); }"
)
_JIT = {}


def _jitted(name):
    """The CUDA expression ``name``, built at its first use."""
    if name not in _JIT:
        from torch.cuda import jiterator

        if name == "matern":
            _JIT[name] = jiterator._create_jit_fn(MATERN, eps=EPS32)
        else:
            _JIT[name] = jiterator._create_multi_output_jit_fn(MATERN_PARTS, num_outputs=2, eps=EPS32)
    return _JIT[name]


def matern(r):
    """``(1 + d) exp(-d)`` with ``d = sqrt(max(r, eps))``, from squared distances ``r``."""
    if r.is_cuda:
        return _jitted("matern")(r, eps=EPS32)
    d = r.clamp(min=EPS32).sqrt_()
    return torch.exp(-d).mul_(d + 1.0)


def matern_parts(m, r):
    """``(m exp(-d), m (1 + d) exp(-d))`` with ``d`` as in ``matern``."""
    if r.is_cuda:
        return _jitted("parts")(m, r, eps=EPS32)
    d = r.clamp(min=EPS32).sqrt_()
    e = torch.exp(-d)
    return m * e, m * ((d + 1.0) * e)


class Gram:
    """Products with ``s k(x_i, x_j)`` for the current (detached) parameters."""

    def __init__(self, X, *, tile, prec):
        self.X = X
        self.n = X.shape[0]
        self.tile = tile
        self.prec = prec
        self.starts = list(range(0, self.n, tile))
        self.pairs = []  # (cotangent, input) of every product that was differentiated

    def set_params(self, ell, s):
        self.ell, self.s = ell.detach(), s.detach()
        z = math.sqrt(3.0) * self.X / self.ell
        sq = torch.sum(z * z, dim=1, keepdim=True)
        one = torch.ones_like(sq)
        # [z, |z|^2, 1] . [-2 z, 1, |z|^2 + eps] = |z_i - z_j|^2 + eps
        self.left = torch.cat([z, sq, one], dim=1)
        self.right = torch.cat([-2 * z, one, sq + EPS32], dim=1)

    def _rows(self, i):
        return slice(i, min(i + self.tile, self.n))

    def squared(self, I, J, diagonal):
        """``|z_i - z_j|^2 + eps`` on a tile; exactly eps on the diagonal."""
        r = self.prec.mm(self.left[I], self.right[J].T)
        if diagonal:
            r.diagonal().fill_(EPS32)
        return r

    def apply(self, V):
        """``s K V`` for ``V (n, m)``."""
        out = torch.zeros_like(V)
        for a, i in enumerate(self.starts):
            I = self._rows(i)
            for j in self.starts[a:]:
                J = self._rows(j)
                k = matern(self.squared(I, J, i == j))
                out[I] += self.prec.mm(k, V[J])
                if i != j:
                    out[J] += self.prec.mm(k.T, V[I])
                del k
        return self.s * out

    def param_grads(self):
        """``sum over pairs (u, w) of u^T (dK/dp) w`` for p = (lengthscale, outputscale),
        in one pass over the tiles, then forget the pairs."""
        U = torch.cat([u for u, _w in self.pairs], dim=1)
        W = torch.cat([w for _u, w in self.pairs], dim=1)
        # An off-diagonal tile carries both orientations: M = U_I W_J^T + W_I U_J^T.
        both_left, both_right = torch.cat([U, W], dim=1), torch.cat([W, U], dim=1)
        x64 = self.X.to(torch.float64)
        feats = torch.cat([torch.ones_like(x64[:, :1]), x64, x64 * x64], dim=1)  # [1, x, x^2]
        d_dim = self.X.shape[1]
        g_s = torch.zeros((), dtype=torch.float64, device=self.X.device)
        g_l = torch.zeros(d_dim, dtype=torch.float64, device=self.X.device)
        for a, i in enumerate(self.starts):
            I = self._rows(i)
            for j in self.starts[a:]:
                J = self._rows(j)
                if i == j:
                    M = self.prec.mm(U[I], W[J].T)
                else:
                    M = self.prec.mm(both_left[I], both_right[J].T)
                P, Q = matern_parts(M, self.squared(I, J, i == j))
                del M
                g_s += Q.sum(dtype=torch.float64)
                del Q
                # sum_j P_ij [1, x_j, x_j^2]: rows of (P 1, P x, P x^2)
                A = P.to(torch.float64) @ feats[J]
                del P
                xi = x64[I]
                g_l += (xi * xi * A[:, :1] - 2.0 * xi * A[:, 1:1 + d_dim] + A[:, 1 + d_dim:]).sum(dim=0)
        self.pairs = []
        ell = self.ell.to(torch.float64)
        # d/d ell_c of s (1 + d) e^-d = 3 s e^-d (x_ic - x_jc)^2 / ell_c^3
        return (3.0 * self.s.to(torch.float64) * g_l / ell**3).to(torch.float32), g_s.to(torch.float32)


def pivoted_cholesky(X, ell, s, *, rank, block, prec):
    """Block-pivoted partial Cholesky of the noiseless kernel matrix (no gradient)."""
    n = X.shape[0]
    z = math.sqrt(3.0) * X / ell
    # k(x_i, x_i): the distance is exactly 0, so d = sqrt(eps) on every row.
    d0 = torch.sqrt(torch.full((n,), EPS32, dtype=X.dtype, device=X.device))
    diag0 = s * ((1.0 + d0) * torch.exp(-d0))
    L = torch.zeros((n, rank), dtype=X.dtype, device=X.device)
    residual = diag0.clone()
    for b in range(rank // block):
        piv = torch.sort(torch.abs(residual), descending=True, stable=True).indices[:block]
        diff = z[:, None, :] - z[None, piv, :]
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + EPS32)
        del diff
        C = s * (1.0 + dist) * torch.exp(-dist) - prec.mm(L, L[piv].T)
        S = C[piv]
        S = 0.5 * (S + S.T)
        w, Q = torch.linalg.eigh(S)
        tol = block * EPS32 * torch.max(torch.abs(w))
        inv_sqrt = torch.where(w > tol, 1.0 / torch.sqrt(torch.clamp(w, min=tol)), torch.zeros_like(w))
        Wb = prec.mm(C, Q) * inv_sqrt
        L[:, b * block:(b + 1) * block] = Wb
        residual = residual - torch.sum(Wb * Wb, dim=1)
    return L


def woodbury(L, noise, prec):
    """``v -> (noise I + L L^T)^{-1} v``."""
    rank = L.shape[1]
    scaled = L / torch.sqrt(noise)
    cap = torch.eye(rank, dtype=L.dtype, device=L.device) + prec.mm(scaled.T, scaled)
    factor = torch.linalg.cholesky(cap)

    def solve(v):
        v_scaled = v / noise
        rhs = prec.mm(scaled.T, v_scaled[:, None])
        return v_scaled - prec.mm(scaled, torch.cholesky_solve(rhs, factor))[:, 0]

    return solve


def _safe_divide(a, b):
    eps = EPS32**2
    big = torch.abs(b) > eps
    return torch.where(big, a / torch.where(big, b, torch.ones_like(b)), a)


class PCG:
    """Adaptive PCG from x = 0, stepped from outside: ``want()`` is the
    vector to multiply next (None once stopped), ``give(Av)`` its product."""

    def __init__(self, b, P, *, atol, rtol, maxiter, miniter):
        self.P, self.atol, self.rtol, self.maxiter, self.miniter = P, atol, rtol, maxiter, miniter
        self.x = torch.zeros_like(b)
        self.r = b.clone()  # b - A 0
        self.p = P(self.r)
        self.rz = torch.dot(self.r, self.p)
        self.steps = 0
        self.done = False
        self._check()

    def _check(self):
        if self.steps >= self.maxiter:
            self.done = True
            return
        err = self.r / (self.atol + torch.abs(self.x) * self.rtol)
        too_large = bool(torch.sqrt(torch.mean(err**2)) > 1.0)
        self.done = not (too_large or self.steps < self.miniter)

    def want(self):
        return None if self.done else self.p

    def give(self, Ap):
        step = _safe_divide(self.rz, torch.dot(self.p, Ap))
        self.x = self.x + step * self.p
        self.r = self.r - step * Ap
        z = self.P(self.r)
        rz_new = torch.dot(self.r, z)
        self.p = z + _safe_divide(rz_new, self.rz) * self.p
        self.rz = rz_new
        self.steps += 1
        self._check()


def log_clipped(x):
    return torch.log(torch.where(x < EPS32, torch.ones_like(x), x))


def loss_and_grad(X, y, params, probes, config, *, prec, tile):
    """The loss and its gradient in the flat parameters, and the forward PCG's steps."""
    c = config
    n, d = X.shape
    theta = params.detach().clone().requires_grad_()
    const, raw_ell, raw_out, raw_noise = theta[0], theta[1:1 + d], theta[1 + d], theta[2 + d]
    ell, s = softplus(raw_ell), softplus(raw_out)
    noise = NOISE_MIN + softplus(raw_noise)
    gram = Gram(X, tile=tile, prec=prec)
    gram.set_params(ell, s)

    rank = min(c["rank_precon"], n)
    rank = max(c["precon_block"], rank // c["precon_block"] * c["precon_block"])
    with torch.no_grad():
        L = pivoted_cholesky(X, ell.detach(), s.detach(), rank=rank, block=c["precon_block"], prec=prec)
        P = woodbury(L, noise.detach(), prec)
        residual = y - const.detach()
        scale_bar = 0.5 / n
        solves = [PCG(b, P, atol=c["cg_tol"], rtol=c["cg_rtol"], maxiter=c["cg_maxiter"],
                      miniter=c["cg_miniter"]) for b in (residual, scale_bar * residual)]

    def pending():
        return [(k, s_.want()) for k, s_ in enumerate(solves) if s_.want() is not None]

    def products(V, extra):
        """``A V`` (recorded for the gradient) and, in the same tile pass,
        ``A p`` of the solves still running."""
        cols = [V] + [p[:, None] for _k, p in extra]
        with torch.no_grad():
            out = gram.apply(torch.cat(cols, dim=1))
        m = V.shape[1]
        for j, (k, p) in enumerate(extra):
            solves[k].give(out[:, m + j] + noise.detach() * p)
        return _Forward.apply(V, out[:, :m], gram, s) + noise * V

    # Blocked Lanczos, re-orthogonalised twice against each probe's own basis.
    Vp = probes.T
    norms_probe = torch.linalg.norm(Vp, dim=0)
    V1 = Vp / norms_probe
    x = V1 / torch.linalg.norm(V1, dim=0)
    x_prev = torch.zeros_like(x)
    beta_prev = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    basis, alphas, betas = [x], [], []
    for _ in range(c["num_matvecs"]):
        ax = products(x, pending())
        alpha = torch.sum(x * ax, dim=0)
        resid = ax - alpha * x - beta_prev * x_prev
        for _twice in range(2):
            stacked = torch.stack(basis)
            proj = prec.einsum("knm,nm->km", stacked, resid)
            resid = resid - prec.einsum("km,knm->nm", proj, stacked)
        beta = torch.linalg.norm(resid, dim=0)
        x_next = resid / beta
        basis.append(x_next)
        alphas.append(alpha)
        betas.append(beta)
        x_prev, x, beta_prev = x, x_next, beta
    with torch.no_grad():
        while pending():
            extra = pending()
            out = gram.apply(torch.stack([p for _k, p in extra], dim=1))
            for j, (k, p) in enumerate(extra):
                solves[k].give(out[:, j] + noise.detach() * p)
    diags = torch.stack(alphas).T
    offdiags = torch.stack(betas[:-1]).T
    T = torch.diag_embed(diags) + torch.diag_embed(offdiags, 1) + torch.diag_embed(offdiags, -1)
    eigvals, eigvecs = torch.linalg.eigh(T)
    first = eigvecs[:, 0, :]
    quad = norms_probe**2 * torch.sum(first * log_clipped(eigvals) * first, dim=-1)
    logdet = torch.mean(quad)

    sol, lam = solves[0].x, solves[1].x
    mahal = torch.dot(residual, sol)
    value = -logdet.detach() / 2 - 0.5 * mahal - n / 2 * math.log(2 * math.pi)
    loss = -value / n
    torch.autograd.backward(logdet, torch.tensor(0.5 / n, dtype=logdet.dtype, device=logdet.device))
    grad = theta.grad.clone()
    # The solve's implicit derivative: -lam^T (dA/dp) sol, and b's cotangent lam.
    gram.pairs.append((-lam[:, None], sol[:, None]))
    g_ell, g_s = gram.param_grads()
    with torch.no_grad():
        grad[1:1 + d] += g_ell * torch.sigmoid(raw_ell)
        grad[1 + d] += g_s * torch.sigmoid(raw_out)
        grad[2 + d] += -torch.dot(lam, sol) * torch.sigmoid(raw_noise)
        grad[0] += -torch.sum(scale_bar * sol + lam)
    return float(loss), grad, solves[0].steps


class _Forward(torch.autograd.Function):
    """``out = s K V``, computed in a shared tile pass, as a function of ``V``
    and of the kernel's parameters (``anchor``, any tensor that depends on
    them, so that every product is differentiated): the backward keeps
    ``(G, V)`` for ``Gram.param_grads`` and returns ``s K G`` for ``V``."""

    @staticmethod
    def forward(ctx, V, out, gram, anchor):
        ctx.gram = gram
        ctx.save_for_backward(V)
        return out.clone()

    @staticmethod
    def backward(ctx, G):
        (V,) = ctx.saved_tensors
        ctx.gram.pairs.append((G.detach(), V.detach()))
        grad_v = ctx.gram.apply(G) if ctx.needs_input_grad[0] else None
        return grad_v, None, None, None


def follow(X, y, params0, probes_list, config, *, precision="float32", tile=16384):
    """Train from ``params0`` for ``len(probes_list)`` steps, as the program
    does: ``{"losses", "grad1", "params", "pcg_steps"}``."""
    prec = Precision(precision)
    lr = config["learning_rate"]
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    params = params0.detach().clone()
    m = torch.zeros_like(params)
    v = torch.zeros_like(params)
    losses, pcg_steps, grad1 = [], [], None
    t = 0
    for probes in probes_list:
        loss, grad, steps = loss_and_grad(X, y, params, probes, config, prec=prec, tile=tile)
        losses.append(loss)
        pcg_steps.append(steps)
        if grad1 is None:
            grad1 = grad.clone()
        if not bool(torch.all(torch.isfinite(grad))):
            continue
        t += 1
        m = beta1 * m + (1 - beta1) * grad
        v = beta2 * v + (1 - beta2) * grad * grad
        bias1, bias2 = 1 - beta1**t, 1 - beta2**t
        denom = v.sqrt() / math.sqrt(bias2) + eps
        params = params - (lr / bias1) * m / denom
    return {"losses": losses, "grad1": grad1, "params": params, "pcg_steps": pcg_steps}


def leaves(flat, d):
    return {"constant": flat[0:1], "lengthscale": flat[1:1 + d], "outputscale": flat[1 + d:2 + d],
            "noise": flat[2 + d:3 + d]}


def numbers_against(got, ref, params0, d):
    """The compared numbers of a program's (or a control's) steps against the reference's."""
    numbers = {}
    for i, (a, b) in enumerate(zip(got["losses"], ref["losses"])):
        numbers[f"loss.step{i + 1}"] = measures.rel_scalar(a, b)
    left_out = []
    g_gaps, g_out = measures.leaf_norm_gaps(leaves(got["grad1"], d), leaves(ref["grad1"], d))
    numbers.update({f"grad1.{k}": v for k, v in g_gaps.items()})
    left_out += [f"grad1.{k}" for k in g_out]
    c_gaps, c_out = measures.leaf_norm_gaps(leaves(got["params"] - params0, d), leaves(ref["params"] - params0, d))
    numbers.update({f"change.{k}": v for k, v in c_gaps.items()})
    left_out += [f"change.{k}" for k in c_out]
    return numbers, left_out


def reference(config, traffic, handoff, device, *, precision="float32"):
    """The reference's steps from the program's inputs (``precision="tf32"``: the control)."""
    return follow(handoff["X"], handoff["y"], handoff["params0"], handoff["probes"], config,
                  precision=precision, tile=traffic.get("reference_tile", 16384))


def judge(config, got, ref, handoff):
    """``(numbers, left_out)`` of steps ``got`` against the reference's ``ref``."""
    numbers, left_out = numbers_against(got, ref, handoff["params0"], config["ndim"])
    numbers["pcg_steps"] = float(sum(abs(a - b) for a, b in zip(got["pcg_steps"], ref["pcg_steps"])))
    return numbers, left_out


def compare(config, traffic, seed, handoff, device):
    return judge(config, handoff, reference(config, traffic, handoff, device), handoff)


def control(config, traffic, seed, handoff, device, ref):
    """The control's numbers: the reference in TF32 in the program's place."""
    got = reference(config, traffic, handoff, device, precision="tf32")
    return judge(config, got, ref, handoff)[0]
