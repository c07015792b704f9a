"""Train state (model + optimizer state + step) and the update steps: the
port's counterpart of percepnet_tpu/train/state.py.

The optimizer is optax's, written out: Adam (b1 0.9, b2 0.999, eps 1e-8,
rnn_train.py:576), optionally after a global-norm clip, inside
`apply_if_finite(max_consecutive_errors=100)`
(optax/transforms/_conditionality.py), in optax's order of operations.
Its state is a flat dict keyed by optax's pytree paths under `opt_state/`
(`notfinite_count`, `inner_state/0/mu/fc/w`, ...), with optax's dtypes,
so a checkpoint moves between the two packages as it is
(train.checkpoint).

Nothing in a step waits for the device: whether the gradient is finite is
a 0-d bool tensor, and the skip is a `torch.where` over the update and the
moments, as JAX's `lax.cond` decides inside the graph.

Data parallel: in a `torch.distributed` process group (one process per
card, parallel.mesh.init_distributed), `train_step` averages the
gradients and the loss over the ranks with one bucketed all-reduce
(parallel.mesh.all_reduce_mean_) between `torch.autograd.grad` and the
optimizer, as JAX's jitted step averages the global batch's gradient.
Every rank then holds the same gradient, so the global-norm clip and
the non-finite skip decide alike everywhere, still without a host sync.
The model is not wrapped in DistributedDataParallel: its reducer fires
as `.grad` accumulates, and this step takes its gradients with
`torch.autograd.grad` under per-frame `torch.utils.checkpoint`, which
the reducer would not see.  With no group the step is unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

from percepnet_tpu_torch.models.percepnet import LAYERS, PercepNet
from percepnet_tpu_torch.parallel import mesh as pm
from percepnet_tpu_torch.train.loss import percepnet_loss

# JAX's leaf order: PercepNetParams fields, each dict's keys sorted
LEAVES: tuple[tuple[str, str], ...] = tuple(
    (layer, leaf) for layer, leaves in LAYERS.items()
    for leaf in sorted(leaves))
_INT32_MAX = 2**31 - 1
# optax.adam's defaults and apply_if_finite's limit, as the JAX package
# uses them
B1, B2, EPS = 0.9, 0.999, 1e-8
MAX_CONSECUTIVE_ERRORS = 100


def parameters(model: PercepNet) -> list[torch.nn.Parameter]:
    """The model's parameters in LEAVES order."""
    return [getattr(model, layer)[leaf] for layer, leaf in LEAVES]


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    """count + 1, saturating at the int32 maximum (optax.safe_increment)."""
    return torch.where(count < _INT32_MAX, count + 1, count)


class _Optimizer:
    """make_optimizer's transformation: update() changes the parameters
    and the state in place and returns nothing."""

    def __init__(self, learning_rate: float, clip_norm: float | None,
                 skip_nonfinite: bool):
        self.learning_rate = learning_rate
        self.clip_norm = clip_norm
        self.skip_nonfinite = skip_nonfinite
        # optax's path of the Adam state: apply_if_finite's inner_state,
        # then the chain's index (clip_by_global_norm's EmptyState is 0)
        self.adam_prefix = (("inner_state/" if skip_nonfinite else "")
                            + ("1/0/" if clip_norm is not None else "0/"))

    def init(self, model: PercepNet) -> dict[str, torch.Tensor]:
        """Zero moments and counters on the model's device."""
        dev = next(model.parameters()).device
        state = {}
        if self.skip_nonfinite:
            state["notfinite_count"] = torch.zeros((), dtype=torch.int32,
                                                   device=dev)
            state["last_finite"] = torch.ones((), dtype=torch.bool,
                                              device=dev)
            state["total_notfinite"] = torch.zeros((), dtype=torch.int32,
                                                   device=dev)
        state[self.adam_prefix + "count"] = torch.zeros(
            (), dtype=torch.int32, device=dev)
        for moment in ("mu", "nu"):
            for (layer, leaf), p in zip(LEAVES, parameters(model)):
                state[f"{self.adam_prefix}{moment}/{layer}/{leaf}"] = \
                    torch.zeros_like(p, memory_format=torch.contiguous_format)
        return state

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: dict[str, torch.Tensor]) -> None:
        """One step on `params` (LEAVES order) with `grads`, in place."""
        apply = None
        if self.skip_nonfinite:
            finite = torch.stack([torch.isfinite(g).all()
                                  for g in grads]).all()
            notfinite = torch.where(
                finite, torch.zeros_like(state["notfinite_count"]),
                _safe_increment(state["notfinite_count"]))
            apply = finite | (notfinite > MAX_CONSECUTIVE_ERRORS)
            state["total_notfinite"] = torch.where(
                finite, state["total_notfinite"],
                _safe_increment(state["total_notfinite"]))
            state["notfinite_count"] = notfinite
            state["last_finite"] = finite
        if self.clip_norm is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.clip_norm
            grads = [torch.where(keep, g, (g / norm) * self.clip_norm)
                     for g in grads]
        pre = self.adam_prefix
        count = _safe_increment(state[pre + "count"])
        bias1 = 1 - torch.pow(B1, count.to(torch.float32))
        bias2 = 1 - torch.pow(B2, count.to(torch.float32))
        for (layer, leaf), p, g in zip(LEAVES, params, grads):
            mu_old = state[f"{pre}mu/{layer}/{leaf}"]
            nu_old = state[f"{pre}nu/{layer}/{leaf}"]
            mu = (1 - B1) * g + B1 * mu_old
            nu = (1 - B2) * (g * g) + B2 * nu_old
            step = (mu / bias1) / (torch.sqrt(nu / bias2) + EPS) \
                * -self.learning_rate
            if apply is not None:
                step = torch.where(apply, step, 0.0)
                mu = torch.where(apply, mu, mu_old)
                nu = torch.where(apply, nu, nu_old)
            mu_old.copy_(mu)
            nu_old.copy_(nu)
            p.add_(step)
        state[pre + "count"] = (count if apply is None else
                                torch.where(apply, count,
                                            state[pre + "count"]))


def make_optimizer(learning_rate: float = 1e-4,
                   clip_norm: float | None = None,
                   skip_nonfinite: bool = True) -> _Optimizer:
    """Adam as in rnn_train.py:576; optional global-norm clip (off by
    default: the reference does not clip), computed as optax does,
    `g if |g| < c else g / |g| * c` (not clip_grad_norm_, which adds 1e-6
    to the norm).  skip_nonfinite skips a step whose gradient is not
    finite instead of poisoning the parameters with it (2000-frame BPTT
    occasionally overflows); a finite step is the same either way."""
    return _Optimizer(learning_rate, clip_norm, skip_nonfinite)


@dataclasses.dataclass
class TrainState:
    model: PercepNet
    opt_state: dict[str, torch.Tensor]
    step: torch.Tensor          # int32 0-d, on the model's device


def init_train_state(model: PercepNet, opt: _Optimizer) -> TrainState:
    dev = next(model.parameters()).device
    return TrainState(model, opt.init(model),
                      torch.zeros((), dtype=torch.int32, device=dev))


def loss_fn(model: PercepNet, features: torch.Tensor, targets: torch.Tensor,
            gain_mse_weight: float = 0.0, log1p_features: bool = False,
            remat: bool = True) -> torch.Tensor:
    """features [B,T,70] (x30-scaled), targets [B,T,68] = concat(g, r).
    remat=True as in JAX's loss_fn: backward recomputes each frame's GRU
    gates instead of storing them for all frames."""
    g, r, _ = model(features, log1p_features=log1p_features, remat=remat)
    return percepnet_loss(torch.cat([g, r], dim=-1), targets,
                          gain_mse_weight=gain_mse_weight)


def train_step(state: TrainState, features: torch.Tensor,
               targets: torch.Tensor, opt: _Optimizer,
               gain_mse_weight: float = 0.0, log1p_features: bool = False,
               remat: bool = True) -> torch.Tensor:
    """One step in place; returns the step's loss, still on the device:
    in a process group, the mean of the ranks' losses."""
    params = parameters(state.model)
    loss = loss_fn(state.model, features, targets, gain_mse_weight,
                   log1p_features, remat)
    grads = list(torch.autograd.grad(loss, params))
    loss = loss.detach()
    pm.all_reduce_mean_([*grads, loss])
    opt.update(params, grads, state.opt_state)
    state.step.add_(1)
    return loss


@torch.no_grad()
def eval_step(state: TrainState, features: torch.Tensor,
              targets: torch.Tensor, gain_mse_weight: float = 0.0,
              log1p_features: bool = False) -> torch.Tensor:
    return loss_fn(state.model, features, targets, gain_mse_weight,
                   log1p_features, remat=False)


def make_steps(opt: _Optimizer, gain_mse_weight: float = 0.0,
               log1p_features: bool = False, remat: bool = True):
    """(train_step, eval_step) on (state, x, y), the counterpart of JAX's
    make_jitted_steps on one device."""
    w, lg = gain_mse_weight, log1p_features

    def step(s, x, y):
        return train_step(s, x, y, opt, w, lg, remat)

    def ev(s, x, y):
        return eval_step(s, x, y, w, lg)
    return step, ev


def make_index_steps(opt: _Optimizer, gain_mse_weight: float = 0.0,
                     log1p_features: bool = False, remat: bool = True):
    """(train_step, eval_step) on (state, x_all, y_all, idx) over a
    corpus resident on the device: the batch is gathered there, so only
    the indices cross from the host (datasets.load_all_chunks)."""
    step, ev = make_steps(opt, gain_mse_weight, log1p_features, remat)

    def index_step(s, xa, ya, idx):
        return step(s, xa[idx], ya[idx])

    def index_ev(s, xa, ya, idx):
        return ev(s, xa[idx], ya[idx])
    return index_step, index_ev
