"""Closed-loop GP training: one trainer, whole Adam steps of ``train.gp.train_step``.

Set-up makes the data from the seed, assembles the port's training stack
(``train.gp.assemble`` with the fused Gram policy) and the optimizer, and
warms every kernel and library call that a step makes with one step of a
second stack built alike on the first ``warmup_rows`` rows. The window
then trains the timed stack from the configuration's initial parameters:
each step draws fresh probes from the seed's generator, and a step that
starts inside the window runs to its end. Its first ``compared_steps``
steps (at least that many run, whatever the window's length) are the ones
the reference follows: their probes, losses and PCG steps, the first
gradient as Adam holds it after step 1, and the parameters after them.
"""

import time

import torch

from portbench.yardstick import data, work


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.steps = []  # per window step: (seconds, pcg steps, K1, K2 launches, applied)
        self.elapsed = None

    def _sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def probes(self):
        c = self.config
        return data.rademacher(self.generator, (c["num_samples"], c["n_train"]), device=self.device)

    def assemble(self, n_train):
        """The port's training stack on ``n_train`` rows, as the configuration states it."""
        from lanczos_adjoints_tpu_torch.ops import gram
        from lanczos_adjoints_tpu_torch.train import gp as train_gp

        c = self.config
        return train_gp.assemble(
            n_train=n_train, ndim=c["ndim"], num_matvecs=c["num_matvecs"],
            num_samples=c["num_samples"], rank_precon=c["rank_precon"], precon_block=c["precon_block"],
            cg_tol=c["cg_tol"], cg_rtol=c["cg_rtol"], cg_maxiter=c["cg_maxiter"], cg_miniter=c["cg_miniter"],
            sample=lambda probes: probes, matvec=gram.gram_matvec_fused(), slq=c["slq"],
            device=self.device, solver_mode="adaptive", train_log=c["train_log"],
            slq_host_batches=c["slq_host_batches"],
        )

    def setup(self):
        t = time.perf_counter()
        from lanczos_adjoints_tpu_torch.ops import native
        from lanczos_adjoints_tpu_torch.train import gp as train_gp

        self.stages = {"import": time.perf_counter() - t}
        c = self.config
        X, y = data.synthetic_gp(self.seed, num_data=c["num_data"], ndim=c["ndim"],
                                 train_fraction=c["train_fraction"])
        if len(X) != c["n_train"]:
            msg = f"the split gives {len(X)} training points, not {c['n_train']}"
            raise ValueError(msg)
        self.X = torch.tensor(X, device=self.device)
        self.y = torch.tensor(y, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(data.seed_of(self.seed, 2))
        self.stack = self.assemble(c["n_train"])
        self.rank = self.stack.rank
        self.params0 = torch.tensor(c["init_params"], dtype=torch.float32, device=self.device)
        self.opt = train_gp.AdamIfFinite(self.params0.clone().requires_grad_(), lr=c["learning_rate"])
        self.train_step = train_gp.train_step
        self.native = native
        self.compared = {"probes": [], "losses": [], "pcg_steps": []}
        self.stages["data_and_stack"] = time.perf_counter() - t - self.stages["import"]
        self.warm_up(train_gp)
        self.stages["warm_up"] = time.perf_counter() - t - sum(self.stages.values())

    def warm_up(self, train_gp):
        """One step of a stack built as the timed one on the first rows, with
        its own optimizer and probes: it loads every kernel a step launches."""
        c = self.config
        rows = min(self.traffic["warmup_rows"], c["n_train"])
        stack = self.assemble(rows)
        opt = train_gp.AdamIfFinite(self.params0.clone().requires_grad_(), lr=c["learning_rate"])
        gen = torch.Generator(device=self.device).manual_seed(data.seed_of(self.seed, 5))
        probes = data.rademacher(gen, (c["num_samples"], rows), device=self.device)
        self.train_step(stack, opt, probes, self.X[:rows], self.y[:rows])
        self._sync()

    def window(self, seconds):
        counts = self.native.launch_counts
        compared = self.traffic["compared_steps"]
        losses = []
        t0 = time.perf_counter()
        end = t0
        while len(self.steps) < compared or end - t0 < seconds:
            before = counts()
            start = time.perf_counter()
            probes = self.probes()
            value, info, _grad, applied = self.train_step(self.stack, self.opt, probes, self.X, self.y)
            self._sync()
            end = time.perf_counter()
            after = counts()
            self.steps.append({
                "seconds": end - start,
                "pcg_steps": int(info["logpdf"]["solve"]["num_steps"]),
                "k1": after["gram_matvec"] - before["gram_matvec"],
                "k2": after["gram_grads"] - before["gram_grads"],
                "applied": bool(applied),
            })
            if len(self.steps) <= compared:
                self.compared["probes"].append(probes)
                losses.append(value)
                if len(self.steps) == 1:
                    # The first gradient as the optimizer got it: Adam's first
                    # moment after one step is (1 - beta1) g.
                    beta1 = self.opt.adam.param_groups[0]["betas"][0]
                    state = self.opt.adam.state[self.opt.params]
                    moment = state.get("exp_avg", torch.zeros_like(self.opt.params))  # none if no step was taken
                    self.compared["grad1"] = (moment / (1.0 - beta1)).detach().clone()
                if len(self.steps) == compared:
                    self.compared["params"] = self.opt.params.detach().clone()
        self.elapsed = end - t0
        self.compared["losses"] = [float(v) for v in losses]
        self.compared["pcg_steps"] = [s["pcg_steps"] for s in self.steps[:compared]]

    def end_to_end(self):
        return {"train_step_s": self.elapsed / len(self.steps)}

    def counts(self):
        return len(self.steps), sum(not s["applied"] for s in self.steps)

    def facts(self):
        c = self.config
        n, d = c["n_train"], c["ndim"]
        depth, probes = c["num_matvecs"], c["num_samples"] // c["slq_host_batches"]
        bounds = [work.gp_step_bound_s(n=n, d=d, depth=depth, probes=probes, pcg_steps=s["pcg_steps"],
                                       rank=self.rank) for s in self.steps]
        return {
            "steps": self.steps,
            "step_bounds_s": bounds,
            # The Gram launches' shapes, from the algorithm: K1 at m = probes
            # (Lanczos and its adjoint) and m = 1 (PCG); K2 at m = depth x
            # probes (the deferred Lanczos VJP) and m = 1 (the solve's VJP).
            "k1_bound_s": max(work.gram_bound_s("K1", n, n, m, d) for m in (1, probes)),
            "k2_bound_s": {"one": work.gram_bound_s("K2", n, n, 1, d),
                           "wide": work.gram_bound_s("K2", n, n, depth * probes, d)},
        }

    def diagnostics(self):
        return {"step_s": [s["seconds"] for s in self.steps], "setup_stages_s": self.stages}

    def handoff(self):
        return {"X": self.X, "y": self.y, "params0": self.params0, **self.compared}

    def close(self):
        self.stack = self.opt = None

