"""The `rollout` driver: each iteration is one call of the program's batched
rollout (the configuration's `program.rollout`, `rollout_fast`) over a
(T, B, nv) control tape from the set-up's initial batch, plus, where the
traffic has `grad`, the traffic's loss and `backward()` to the tape.

Traffic keys: batch, steps, tau_scale, tape_pool (tapes drawn at set-up;
iteration i takes tape i mod pool), grad, loss ({q_index, tau_weight}:
mean(q_T[:, q_index]^2) + tau_weight mean(tau^2)), warmup_iterations,
check_iterations, check_rows, trace_iterations.

What is compared (once the window has closed): for `check_iterations`
iterations drawn from the seed, on `check_rows` envs drawn from the seed,
the final q and v and, with grad, d loss / d tau, against the reference
(portbench/reference/runner.py) on the same inputs. Each env is an answer
of its own: a row's result depends on that row's inputs alone.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness import check
from portbench.reference import runner


class Driver:
    def __init__(self, cell, seed: int, device):
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr, self.device = cfg, tr, torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])
        self.rollout = runner.resolve(cfg["program"]["rollout"])
        self.state_cls = runner.resolve(cfg["program"]["state"])
        spec = cfg["model"]
        self.model = runner.resolve(spec["program"])(device=self.device, dtype=self.dtype,
                                                      **spec.get("kwargs", {}))
        self.B, self.T, nv = tr["batch"], tr["steps"], self.model.nv
        self.grad = bool(tr.get("grad"))
        self.rng = np.random.default_rng(seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        q0 = torch.tensor(cfg["init_q"], dtype=self.dtype, device=self.device)
        self.q0 = q0.expand(self.B, -1).contiguous()
        self.v0 = torch.zeros(self.B, nv, dtype=self.dtype, device=self.device)
        self.taus = tr["tau_scale"] * torch.randn((tr["tape_pool"], self.T, self.B, nv),
                                                  generator=gen, device=self.device,
                                                  dtype=self.dtype)
        self.env_steps = self.B * self.T
        self.keep, self.kept = set(), {}  # the iterations drawn for the check, their outputs
        self.latest = None  # (iteration, outputs) of the newest
        self._rows, self._want = None, {}  # the check's rows; the reference's answers
        self._ref_model = None

    def plan_check(self, expected_iterations: int, first: int):
        """Draw from the seed the iterations whose outputs are kept for the
        check, among the first half of those the window is expected to hold
        (the last completed iteration stands in for any that never runs)."""
        span = max(self.tr["check_iterations"], expected_iterations // 2)
        self.keep = {first + int(i) for i in
                     self.rng.choice(span, self.tr["check_iterations"], replace=False)}

    def iterate(self, i: int, keep: bool = True):
        taus = self.taus[i % self.tr["tape_pool"]]
        state = self.state_cls(q=self.q0, v=self.v0)
        if self.grad:
            taus = taus.detach().requires_grad_(True)
            with torch.profiler.record_function("portbench.rollout_fast"):
                final = self.rollout(self.model, state, taus)
            loss = self.tr["loss"]
            value = ((final.q[:, loss["q_index"]] ** 2).mean()
                     + loss["tau_weight"] * (taus ** 2).mean())
            with torch.profiler.record_function("portbench.backward"):
                value.backward()
            out = (final.q.detach(), final.v.detach(), taus.grad)
        else:
            with torch.no_grad(), torch.profiler.record_function("portbench.rollout_fast"):
                final = self.rollout(self.model, state, taus)
            out = (final.q, final.v)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if keep:
            self.latest = (i, out)
            if i in self.keep:
                self.kept[i] = out

    def release(self):
        """Free the program's state before the reference runs."""
        self.model = self.rollout = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control=None) -> dict:
        """The numbers compared, over the kept iterations drawn for the check
        (or the last completed one) and `check_rows` rows drawn from the
        seed. `control` (the configuration's: its compute_dtype) puts the
        reference, run in that precision, in the program's place. The
        reference's answers are computed once and kept for a second call."""
        kept = dict(self.kept) or dict([self.latest])
        if self._rows is None:
            n = min(self.tr["check_rows"], self.B)
            self._rows = torch.as_tensor(np.sort(self.rng.choice(self.B, n, replace=False)),
                                         device=self.device)
        rows = self._rows
        numbers = []
        for i, outputs in sorted(kept.items()):
            taus = self.taus[i % self.tr["tape_pool"]][:, rows]
            q0, v0 = self.q0[rows], self.v0[rows]
            if control is None:
                got = [x[rows] if x.shape[0] == self.B else x[:, rows] for x in outputs]
            else:
                got = self._reference(q0, v0, taus, **control)
            if i not in self._want:
                self._want[i] = self._reference(q0, v0, taus)
            numbers.append(self._compare(got, self._want[i], taus))
        return check.worst(numbers)

    def _reference(self, q0, v0, taus, compute_dtype=None):
        """The reference's answers for these rows: its model built in the
        configuration's dtype, the step run in compute_dtype (a dtype's
        name; default: the configuration's)."""
        if self._ref_model is None:
            self._ref_model = runner.build_model(self.cfg, self.device, self.dtype)
        model = self._ref_model
        if compute_dtype is not None:
            compute_dtype = getattr(torch, compute_dtype)
        if self.grad:
            out = runner.bptt(model, q0, v0, taus, self.tr["loss"], self.B, compute_dtype)
        else:
            with torch.no_grad():
                out = runner.final_state(model, q0, v0, taus, compute_dtype)
        return [x.to(self.dtype) for x in out]

    def _compare(self, got, want, taus) -> dict:
        out = check.state_numbers(got[0], got[1], want[0], want[1])
        if self.grad:
            # the regulariser's own gradient, 2 w tau / (T B nv), is the same on
            # both sides: what is compared is the part through the rollout
            reg = 2 * self.tr["loss"]["tau_weight"] * taus / taus[:, :1].numel() / self.B
            out.update(check.grad_numbers(got[2] - reg, want[2] - reg))
        return out
