"""RAdam and torch-exact Adam with the JAX package's update math
(radtts_tpu/train/optim.py:33-135), as torch.optim.Optimizers on
torch._foreach_* ops, and the global-norm clip of optax.

RAdam (the reference's radam.py): the bias-corrected step
lr * rect / (1 - b1^t) * m / (sqrt(v) + eps), with rect carrying
sqrt(1 - b2^t) and eps outside it; lr / (1 - b1^t) * m while the
rectification term N_sma < 5; weight decay adds wd * lr * p to the step.
Adam: torch.optim.Adam's (L2 decay wd * p added to the gradient, eps after
the bias correction of sqrt(v)). The step's scalars are computed in fp32,
as the JAX package computes them.

state_dtype "bfloat16" (train_config.optim_state_dtype) stores the moments
m and v in bf16, halving their bytes; each step widens them to fp32,
updates them and computes the step in fp32, then stores them rounded back
to bf16, as the JAX package does (radtts_tpu/train/optim.py:72-74,
106-108). None, "" or "float32" keeps fp32 moments.
"""

import numpy as np
import torch
import torch.distributed


def _scalar(x):
    return float(np.float32(x))


class _Moments(torch.optim.Optimizer):
    def __init__(self, params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, state_dtype=None):
        dtypes = {None: None, "": None, "float32": None,
                  torch.float32: None, "bfloat16": torch.bfloat16,
                  torch.bfloat16: torch.bfloat16}
        if state_dtype not in dtypes:
            raise ValueError(f"optimizer state dtype {state_dtype!r}: "
                             "float32 or bfloat16 moments only")
        self.state_dtype = dtypes[state_dtype]
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    def _moments(self, group):
        """(params, grads, m, v, t) of a group; a parameter without a
        gradient takes a zero one, as a masked JAX gradient is zero. With
        bf16 state, m and v are fp32 copies (see _store)."""
        params, grads, ms, vs = [], [], [], []
        for p in group["params"]:
            state = self.state[p]
            if not state:
                state["step"] = 0
                state["exp_avg"] = torch.zeros_like(p, dtype=self.state_dtype)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, dtype=self.state_dtype)
            state["step"] += 1
            params.append(p)
            grads.append(p.grad if p.grad is not None
                         else torch.zeros_like(p))
            ms.append(state["exp_avg"].to(p.dtype))
            vs.append(state["exp_avg_sq"].to(p.dtype))
        t = self.state[group["params"][0]]["step"] if params else 0
        return params, grads, ms, vs, t

    def load_state_dict(self, state_dict):
        # torch.optim casts loaded moments to the parameters' dtype
        super().load_state_dict(state_dict)
        if self.state_dtype is not None:
            for state in self.state.values():
                for k in ("exp_avg", "exp_avg_sq"):
                    if k in state:
                        state[k] = state[k].to(self.state_dtype)

    def _store(self, params, ms, vs):
        """Round the updated moments back into bf16 state (a no-op with
        fp32 state, whose m and v were updated in place)."""
        if self.state_dtype is None:
            return
        for p, m, v in zip(params, ms, vs):
            self.state[p]["exp_avg"].copy_(m)
            self.state[p]["exp_avg_sq"].copy_(v)

    @staticmethod
    def _update_moments(grads, ms, vs, b1, b2):
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, torch._foreach_mul(
            torch._foreach_mul(grads, 1 - b2), grads))


class RAdam(_Moments):
    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params, grads, ms, vs, t = self._moments(group)
            if not params:
                continue
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            self._update_moments(grads, ms, vs, b1, b2)
            f = np.float32
            tf = f(t)
            beta2_t = f(b2) ** tf
            n_sma_max = f(2.0 / (1 - b2) - 1.0)
            n_sma = n_sma_max - f(2.0) * tf * beta2_t / (f(1) - beta2_t)
            bias1 = f(1) - f(b1) ** tf
            if n_sma >= 5.0:
                rect = np.sqrt(
                    (f(1) - beta2_t) * (n_sma - f(4)) / (n_sma_max - f(4))
                    * (n_sma - f(2)) / n_sma * n_sma_max
                    / (n_sma_max - f(2)))
                delta = torch._foreach_mul(ms, _scalar(f(lr) * rect / bias1))
                denom = torch._foreach_sqrt(vs)
                torch._foreach_add_(denom, eps)
                torch._foreach_div_(delta, denom)
            else:
                delta = torch._foreach_mul(ms, _scalar(f(lr) / bias1))
            if wd != 0:
                torch._foreach_add_(delta, torch._foreach_mul(
                    params, _scalar(wd * lr)))
            torch._foreach_sub_(params, delta)
            self._store(params, ms, vs)


class Adam(_Moments):
    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params, grads, ms, vs, t = self._moments(group)
            if not params:
                continue
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            if wd != 0:
                grads = torch._foreach_add(grads, torch._foreach_mul(
                    params, wd))
            self._update_moments(grads, ms, vs, b1, b2)
            f = np.float32
            bias1 = f(1) - f(b1) ** f(t)
            bias2 = f(1) - f(b2) ** f(t)
            denom = torch._foreach_sqrt(vs)
            torch._foreach_div_(denom, _scalar(np.sqrt(bias2)))
            torch._foreach_add_(denom, eps)
            delta = torch._foreach_mul(ms, _scalar(f(lr) / bias1))
            torch._foreach_div_(delta, denom)
            torch._foreach_sub_(params, delta)
            self._store(params, ms, vs)


def clip_grad_norm(params, max_norm, sharded=(), group=None):
    """optax.clip_by_global_norm: scale every gradient by max_norm / norm
    when the global norm is at least max_norm (no epsilon). Returns the
    norm before the clip; a parameter without a gradient counts as 0.
    With a model group, the parameters in `sharded` hold tensor-parallel
    shards: their squared norms are summed over the group (one small
    all-reduce), each replicated gradient counted once, so the norm is
    that of the full logical parameters."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if group is None:
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
    else:
        ids = {id(p) for p in sharded}
        parts = [[p.grad for p in params if p.grad is not None
                  and (id(p) in ids) == s] for s in (False, True)]
        sq = [torch.stack(torch._foreach_norm(g)).square().sum() if g
              else grads[0].new_zeros(()) for g in parts]
        torch.distributed.all_reduce(sq[1], group=group)
        norm = (sq[0] + sq[1]).sqrt()
    if max_norm and max_norm > 0:
        scale = torch.where(norm < max_norm, torch.ones_like(norm),
                            max_norm / norm)
        torch._foreach_mul_(grads, scale)
    return norm


def build_optimizer(params, optim_algo, learning_rate, weight_decay,
                    state_dtype=None):
    """RAdam or Adam over params (train.py:340-348)."""
    cls = {"RAdam": RAdam, "Adam": Adam}.get(optim_algo)
    if cls is None:
        raise ValueError(f"Unrecognized optimizer {optim_algo}")
    return cls(params, lr=learning_rate, weight_decay=weight_decay,
               state_dtype=state_dtype)
