"""Closed-loop Lanczos VJPs: one caller, each request a forward + VJP through
``krylov.lanczos.tridiag`` on a DIA operator from ``ops.sparse.sparse_operator``.

Set-up builds the operator from the configuration's COO matrix and draws a
pool of start vectors and cotangents (on the basis, the diagonals, the
off-diagonals, the residual vector and its norm) from the seed; requests
cycle through the pool. A request returns the gradients in the start
vector and the DIA values, and ends after a synchronise. The requests
whose outputs are compared are drawn from the seed before the window.
"""

import time

import numpy as np
import torch

from portbench.yardstick import data


def operator_coo(config):
    if config["operator"] != "laplacian_2d":
        msg = f"operator {config['operator']!r}"
        raise ValueError(msg)
    return data.laplacian_2d_coo(config["grid"])


def leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in leaves(o)]


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.latencies, self.enqueue, self.kept = [], [], {}
        self.elapsed = None

    def _sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def setup(self):
        from lanczos_adjoints_tpu_torch.krylov import lanczos
        from lanczos_adjoints_tpu_torch.ops import sparse

        c, t = self.config, self.traffic
        rows, cols, vals = operator_coo(c)
        self.n = c["grid"] ** 2
        mat = sparse.csr_from_coo(rows, cols, vals, shape=(self.n, self.n))
        matvec, values = sparse.sparse_operator(mat, format=c["format"], device=self.device)
        self.vals = values.detach().requires_grad_()
        self.estimate = lanczos.tridiag(matvec, c["depth"], reortho=c["reortho"])
        depth, n = c["depth"], self.n
        gen = torch.Generator(device=self.device).manual_seed(data.seed_of(self.seed, 3))

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)

        self.pool = []
        for _ in range(t["pool"]):
            v0 = normal(n).requires_grad_()
            cot = [normal(depth, n), normal(depth), normal(depth - 1), normal(n), normal()]
            self.pool.append((v0, cot))
        rng = np.random.default_rng(data.seed_of(self.seed, 4))
        self.sample = {int(i) for i in rng.choice(t["sample_from_first"], size=t["sample"], replace=False)}
        self.sample.add(0)
        for i in range(t["warmup"]):
            self.request(i % len(self.pool))
        self._sync()

    def request(self, p):
        v0, cot = self.pool[p]
        start = time.perf_counter()
        outputs = leaves(self.estimate(v0, self.vals))
        grads = torch.autograd.grad(outputs, [v0, self.vals], cot)
        enqueued = time.perf_counter()
        self._sync()
        return start, enqueued, time.perf_counter(), outputs, grads

    def window(self, seconds):
        t0 = time.perf_counter()
        end, i = t0, 0
        while i == 0 or end - t0 < seconds:
            p = i % len(self.pool)
            start, enqueued, end, outputs, grads = self.request(p)
            self.latencies.append(end - start)
            self.enqueue.append(enqueued - start)
            if i in self.sample:
                self.kept[i] = (p, [o.detach() for o in outputs], [g.detach() for g in grads])
            i += 1
        self.kept[i - 1] = (p, [o.detach() for o in outputs], [g.detach() for g in grads])
        self.elapsed = end - t0

    def end_to_end(self):
        lat = sorted(self.latencies)
        p95 = lat[min(len(lat) - 1, int(np.ceil(0.95 * len(lat))) - 1)]
        return {"grad_per_s": len(lat) / self.elapsed, "grad_p95_ms": 1e3 * p95}

    def counts(self):
        return len(self.latencies), 0

    def facts(self):
        c = self.config
        return {"requests": len(self.latencies), "elapsed_s": self.elapsed,
                "enqueue_s": list(self.enqueue), "n": self.n, "num_diags": c["num_diags"],
                "depth": c["depth"]}

    def diagnostics(self):
        """Quartiles of the host's enqueue time and of the latency, in ms."""
        out = {}
        for name, values in (("enqueue_ms", self.enqueue), ("latency_ms", self.latencies)):
            q = np.quantile(np.asarray(values) * 1e3, [0.25, 0.5, 0.75])
            out[name] = [float(v) for v in q]
        return out

    def handoff(self):
        return {"kept": self.kept, "pool": [(v0.detach(), cot) for v0, cot in self.pool]}

    def close(self):
        self.estimate = self.vals = None
