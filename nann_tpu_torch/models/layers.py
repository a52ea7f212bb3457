"""Building blocks as plain functions over parameter dicts.

Counterpart of `nann_tpu/models/layers.py`: dense (+ batch or layer norm)
(+ PReLU or ReLU) blocks over nested dicts of tensors with the same names as
the JAX pytrees (`dense/kernel`, `bn/gamma`, `prelu/alpha`, and the state's
`bn/mean`, `bn/var`), so bundles map onto them name for name. `batch_norm`
and `dnn_apply` are the eval mode (the moving statistics); `batch_norm_train`
and `dnn_apply_train` the training mode (batch statistics, and the new moving
statistics returned beside the output; with a "dp" process group, the
statistics of the global batch).

Products follow the JAX cast points: inputs and kernels are rounded to the
compute dtype, multiplied with float32 accumulation, and the block's output is
rounded to the compute dtype again (`layers.py:73-80`). Rounding first and
multiplying in float32 gives the same numbers on the CPU and on the card.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

Params = Dict[str, object]
State = Dict[str, object]


# ----------------------------------------------------------------------------- init


def _truncated_normal(shape, gen: torch.Generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               use_bias: bool = True) -> Params:
    """Variance-scaling (fan_in, truncated-normal) kernel + 0.1 bias."""
    stddev = math.sqrt(1.0 / in_dim) / 0.87962566103423978
    p: Params = {"kernel": stddev * _truncated_normal((in_dim, out_dim), gen)}
    if use_bias:
        p["bias"] = torch.full((out_dim,), 0.1)
    return p


def prelu_init(dim: int) -> Params:
    return {"alpha": torch.full((dim,), 0.25)}


def bn_init(dim: int) -> Tuple[Params, State]:
    return ({"gamma": torch.ones(dim), "beta": torch.zeros(dim)},
            {"mean": torch.zeros(dim), "var": torch.ones(dim)})


def ln_init(dim: int) -> Params:
    return {"gamma": torch.ones(dim), "beta": torch.zeros(dim)}


def dnn_init(gen: torch.Generator, in_dim: int, out_dim: int,
             use_bias: bool = True, norm_op: Optional[str] = None,
             active_op: Optional[str] = None) -> Tuple[Params, State]:
    """One `DNN` block: dense [+bn|ln] [+prelu]."""
    params: Params = {"dense": dense_init(gen, in_dim, out_dim, use_bias)}
    state: State = {}
    if norm_op == "bn":
        params["bn"], state["bn"] = bn_init(out_dim)
    elif norm_op == "ln":
        params["ln"] = ln_init(out_dim)
    if active_op == "prelu":
        params["prelu"] = prelu_init(out_dim)
    return params, state


# ----------------------------------------------------------------------------- apply


def matmul_f32(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x @ w with both rounded to `dt` and the sum taken in float32."""
    return torch.matmul(x.to(dt).float(), w.to(dt).float())


def dense(p: Params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """y = x @ W (+ b), rounded to the compute dtype."""
    dt = compute_dtype or x.dtype
    y = matmul_f32(x, p["kernel"], dt)
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(dt)


def prelu(p: Params, x: torch.Tensor) -> torch.Tensor:
    alpha = p["alpha"].to(x.dtype)
    return torch.clamp(x, min=0) + alpha * torch.clamp(x, max=0)


def layer_norm(p: Params, x: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    # population variance, as jnp.var (torch.var defaults to the unbiased one)
    var = x.var(-1, keepdim=True, correction=0)
    normed = (x - mean) * torch.rsqrt(var + epsilon)
    return p["gamma"].to(x.dtype) * normed + p["beta"].to(x.dtype)


def batch_norm(p: Params, s: State, x: torch.Tensor,
               epsilon: float = 1e-3) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis from the moving statistics."""
    scale = p["gamma"].float() * torch.rsqrt(s["var"].float() + epsilon)
    shift = p["beta"].float() - s["mean"].float() * scale
    return (x.float() * scale + shift).to(x.dtype)


def batch_norm_train(p: Params, s: State, x: torch.Tensor,
                     momentum: float = 0.99, epsilon: float = 1e-3,
                     group=None) -> Tuple[torch.Tensor, State]:
    """Training-mode BatchNorm over all axes but the last: normalises by the
    batch statistics and returns (y, new moving statistics), as
    nann_tpu/models/layers.py:95-120 with training=True.

    With `group` (the "dp" process group of a batch split evenly over its
    ranks, x this rank's block) the statistics are the global batch's, as
    JAX computes them on a "dp" mesh: the mean from an all-reduced sum, the
    variance from an all-reduced sum of squared deviations from that mean
    (jnp.var's two passes; E[x^2] - E[x]^2 cancels over 160,800 float32
    rows), both over the global row count. Every rank gets the same
    statistics and so the same new state. Each rank backprops its own share
    of the loss (collectives.all_reduce_sum)."""
    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    if group is None:
        mean = xf.mean(axes)
        # Divergence guard (population variance): jnp.var is ddof=0,
        # torch.var defaults to the unbiased estimate. Both the
        # normalisation and the moving variance below use this population
        # variance.
        var = xf.var(axes, correction=0)
    else:
        from ..parallel.collectives import all_reduce_sum
        count = xf[..., 0].numel() * dist.get_world_size(group)
        mean = all_reduce_sum(xf.sum(axes), group) / count
        var = all_reduce_sum(((xf - mean) ** 2).sum(axes), group) / count
    new_state = {
        "mean": momentum * s["mean"] + (1 - momentum) * mean.detach(),
        "var": momentum * s["var"] + (1 - momentum) * var.detach(),
    }
    scale = p["gamma"].float() * torch.rsqrt(var + epsilon)
    shift = p["beta"].float() - mean * scale
    return (xf * scale + shift).to(x.dtype), new_state


def _norm_act(p: Params, out: torch.Tensor, norm_op: Optional[str],
              active_op: Optional[str]) -> torch.Tensor:
    """A block's layer norm and activation, after its dense (and BN)."""
    if norm_op == "ln":
        out = layer_norm(p["ln"], out)
    if active_op == "prelu":
        out = prelu(p["prelu"], out)
    elif active_op == "relu":
        out = torch.relu(out)
    return out


def dnn_apply(p: Params, s: State, x: torch.Tensor,
              norm_op: Optional[str] = None, active_op: Optional[str] = None,
              bn_epsilon: float = 1e-3, compute_dtype=None) -> torch.Tensor:
    """One block in eval mode."""
    out = dense(p["dense"], x, compute_dtype)
    if norm_op == "bn":
        out = batch_norm(p["bn"], s["bn"], out, bn_epsilon)
    return _norm_act(p, out, norm_op, active_op)


def dnn_apply_train(p: Params, s: State, x: torch.Tensor,
                    norm_op: Optional[str] = None,
                    active_op: Optional[str] = None,
                    bn_momentum: float = 0.99, bn_epsilon: float = 1e-3,
                    compute_dtype=None, group=None
                    ) -> Tuple[torch.Tensor, State]:
    """One block in training mode: (output, the block's new state); with
    `group`, the batch norm's statistics over the global batch."""
    out = dense(p["dense"], x, compute_dtype)
    new_s: State = {}
    if norm_op == "bn":
        out, new_s["bn"] = batch_norm_train(p["bn"], s["bn"], out,
                                            bn_momentum, bn_epsilon, group)
    return _norm_act(p, out, norm_op, active_op), new_s
