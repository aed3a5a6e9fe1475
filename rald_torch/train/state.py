"""Train state: f32 master parameters, their EMA and the optimizer
(``rald_tpu/train/state.py:22-105``).

The JAX package keeps ``params``, ``ema_params`` and an optax chain's state
in one pytree: global-norm clip -> AdamW(0.9, 0.999, eps 1e-8, weight decay
0.01 on every parameter), wrapped in ``optax.apply_if_finite`` with
``skip_nonfinite`` and in ``optax.MultiSteps`` with ``accum_iter > 1``,
then EMA 0.999 after every ``apply_gradients``. :class:`TrainState` keeps
the same semantics:

- clip: scale by ``max_norm / g_norm`` only when ``g_norm >= max_norm``, as
  ``optax.clip_by_global_norm`` does (``torch.nn.utils.clip_grad_norm_``
  adds 1e-6 and clips below the norm, so it is not used);
- AdamW: ``torch.optim.AdamW`` with its ``lr`` set to ``schedule(count)``
  before each applied update, ``count`` the updates applied so far (from
  0), which is optax's arithmetic in another order of roundings;
- ``skip_nonfinite`` (``apply_if_finite(max_consecutive_errors=100)``): a
  non-finite gradient leaves params and Adam moments as they were, unless
  more than 100 came in a row; ``step`` and the EMA still move;
- ``accum_iter = k > 1`` (``MultiSteps``): gradients are averaged over k
  calls (optax's running mean), and clip, the finiteness check and AdamW
  see the average on every k-th call; ``count`` and so the schedule advance
  once per k calls. Between those calls the params do not move;
- EMA: ``ema <- 0.999 * ema + 0.001 * params`` after every call.

``params`` may be the model's own float32 parameters (f32 compute) or
f32 masters of a lower-precision working copy (``working``), which is
refreshed from the masters after every applied update and every load.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from rald_torch.train.profiler import span

MAX_CONSECUTIVE_ERRORS = 100


class TrainState:
    def __init__(
        self,
        params: dict,
        learning_rate: Callable | float,
        clip_grad: Optional[float] = None,
        weight_decay: float = 0.01,
        skip_nonfinite: bool = False,
        accum_iter: int = 1,
        ema_rate: float = 0.999,
        working: Optional[dict] = None,
    ):
        """``params``: name -> float32 tensor, updated in place. ``working``:
        name -> the model's parameter of the same name, where it is another
        tensor (a bf16 copy); None where ``params`` are the model's own."""
        self.params = params
        # real copies, not aliases
        self.ema_params = {k: v.detach().clone() for k, v in params.items()}
        self.schedule = learning_rate if callable(learning_rate) else (lambda _: float(learning_rate))
        self.clip_grad = float(clip_grad) if clip_grad else None
        self.skip_nonfinite = bool(skip_nonfinite)
        self.accum_iter = int(accum_iter)
        self.ema_rate = float(ema_rate)
        self.working = working
        self.step = 0
        self.count = 0  # updates AdamW applied: the schedule's argument
        self.mini_step = 0
        self.notfinite_count = self.total_notfinite = 0
        tensors = list(params.values())
        self.acc_grads = [torch.zeros_like(p) for p in tensors] if self.accum_iter > 1 else None
        self.optimizer = torch.optim.AdamW(tensors, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=weight_decay)
        for p in tensors:  # the moments exist from the start, as optax's do
            self.optimizer.state[p] = {"step": torch.tensor(0.0),
                                       "exp_avg": torch.zeros_like(p),
                                       "exp_avg_sq": torch.zeros_like(p)}

    def lr(self) -> float:
        """The learning rate of the next applied update."""
        return float(self.schedule(self.count))

    def apply_gradients(self, grads: dict) -> bool:
        """One optax ``apply_gradients`` with float32 ``grads`` (name ->
        tensor, consumed). Returns whether the params moved."""
        g = [grads[k] for k in self.params]
        applied = False
        if self.acc_grads is None:
            applied = self._update(g)
        else:
            n = self.mini_step
            # optax's running mean: acc + (g - acc) / (n + 1)
            torch._foreach_sub_(g, self.acc_grads)
            torch._foreach_div_(g, float(n + 1))
            torch._foreach_add_(self.acc_grads, g)
            if n == self.accum_iter - 1:
                applied = self._update(self.acc_grads)
                # optax resets with (1 - emit) * acc, which keeps a NaN
                torch._foreach_mul_(self.acc_grads, 0.0)
            self.mini_step = (n + 1) % self.accum_iter
        self.step += 1
        with span("ema"):
            torch._foreach_mul_(list(self.ema_params.values()), self.ema_rate)
            torch._foreach_add_(list(self.ema_params.values()), list(self.params.values()),
                                alpha=1.0 - self.ema_rate)
        return applied

    def _update(self, g: list) -> bool:
        """apply_if_finite(clip -> AdamW) on one gradient list."""
        if self.skip_nonfinite:
            finite = bool(torch.stack([torch.isfinite(t).all() for t in g]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            self.total_notfinite += 0 if finite else 1
            if not finite and self.notfinite_count <= MAX_CONSECUTIVE_ERRORS:
                return False
        if self.clip_grad is not None:
            with span("clip"):
                g_norm = float(global_norm(g))
                if not g_norm < self.clip_grad:
                    torch._foreach_div_(g, g_norm)
                    torch._foreach_mul_(g, self.clip_grad)
        with span("adamw"):
            for p, t in zip(self.params.values(), g):
                p.grad = t
            self.optimizer.param_groups[0]["lr"] = self.lr()
            self.optimizer.step()
            for p in self.params.values():
                p.grad = None
        self.count += 1
        with span("refresh"):
            self.refresh_working()
        return True

    @torch.no_grad()
    def refresh_working(self) -> None:
        """Copy the masters into the working copy (cast to its dtype)."""
        if self.working:
            torch._foreach_copy_([self.working[k] for k in self.params], list(self.params.values()))

    # ------------------------------------------------------------ save / load
    def opt_state(self) -> dict:
        """The optimizer's state by parameter name: Adam's ``mu`` / ``nu``
        and the counters (optax's ``count`` is ``count`` here)."""
        st = self.optimizer.state
        out = {
            "count": self.count,
            "mu": {k: st[p]["exp_avg"] for k, p in self.params.items()},
            "nu": {k: st[p]["exp_avg_sq"] for k, p in self.params.items()},
            "mini_step": self.mini_step,
            "notfinite_count": self.notfinite_count,
            "total_notfinite": self.total_notfinite,
        }
        if self.acc_grads is not None:
            out["acc_grads"] = dict(zip(self.params, self.acc_grads))
        return out

    @torch.no_grad()
    def load(self, params: dict, ema_params: dict, opt_state: dict, step: int) -> "TrainState":
        """Set every value in place (tensors are copied onto this state's
        devices and dtypes); the working copy follows."""
        st = self.optimizer.state
        for k, p in self.params.items():
            p.copy_(params[k])
            self.ema_params[k].copy_(ema_params[k])
            st[p]["exp_avg"].copy_(opt_state["mu"][k])
            st[p]["exp_avg_sq"].copy_(opt_state["nu"][k])
            st[p]["step"].fill_(int(opt_state["count"]))
        self.count = int(opt_state["count"])
        self.mini_step = int(opt_state.get("mini_step", 0))
        self.notfinite_count = int(opt_state.get("notfinite_count", 0))
        self.total_notfinite = int(opt_state.get("total_notfinite", 0))
        if self.acc_grads is not None:
            acc = opt_state.get("acc_grads")
            for k, a in zip(self.params, self.acc_grads):
                a.copy_(acc[k]) if acc is not None else a.zero_()
        self.step = int(step)
        self.refresh_working()
        return self


def masters_of(model: torch.nn.Module, dtype: torch.dtype) -> tuple:
    """``(params, working)`` of a model whose float32 parameters train in
    ``dtype``: in float32 the model's own parameters and None; otherwise
    float32 masters, with the model cast to ``dtype`` as their working
    copy (name -> the model's parameter)."""
    if dtype == torch.float32:
        return {k: p.detach() for k, p in model.named_parameters()}, None
    params = {k: p.detach().float().clone() for k, p in model.named_parameters()}
    model.to(dtype=dtype)
    return params, dict(model.named_parameters())


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))
