"""Training objective: logQ-corrected sampled sigmoid cross-entropy + FGSM
(nann_tpu/train/objective.py).

  1. per batch, draw B*num_neg unique popularity-weighted negatives and build
     per-row targets [gt, neg_1..neg_n] with labels [1, 0..0],
  2. logits -= log(expected_count)  (the sampled-softmax logQ correction),
  3. loss_xe = mean sigmoid cross-entropy,
  4. FGSM: perturb the item tower's output by eps * sign(d loss_xe / d
     item_emb) and add KL(clean logits || adversarial logits), the clean
     logits detached.

JAX takes the inner gradient with `jax.value_and_grad` inside the outer
`jax.grad`; here it is `torch.autograd.grad` with the graph retained, and the
optimizer's gradient is one `backward()` of the returned loss. sign() has a
zero derivative in both, so no gradient flows through the inner gradient.

Over a "dp" process group (the batch split evenly over its ranks) the loss
is the global batch's, as JAX's step on a "dp" mesh computes it: every rank
draws the same B_global * num_neg negatives and keeps its block of rows, the
batch norms take global statistics, and each mean is a local sum over the
global count. Each rank returns its own share of the loss to backprop (the
shares sum to the global loss; the statistics' all-reduce sums their
gradients back), and the metrics all-reduced. The inner FGSM gradient is
that of the rank's share by its own item embeddings: through the
statistics' all-reduce it is the global loss_xe's gradient by those rows.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import ModelConfig, TrainConfig
from ..models import scorer
from ..models.layers import Params, State
from .sampler import expected_count, sample_negatives


def build_targets(generator: torch.Generator, batch: Dict[str, torch.Tensor],
                  item_ids: torch.Tensor, cate_ids: torch.Tensor,
                  log_probs: torch.Tensor, probs: torch.Tensor,
                  num_neg: int, dp: int = 1, dp_index: int = 0
                  ) -> Dict[str, torch.Tensor]:
    """Assemble [B, 1+num_neg] target ids / cate ids / labels / log expected
    counts (objective.py:33-67).

    With dp > 1 the batch is block `dp_index` of a global batch of dp * B
    rows: the draw is the global one (num_neg * dp * B negatives, the same
    on every rank from the same generator), this block keeps its rows of
    the [dp * B, num_neg] draw, and the expected counts are those of the
    global sample."""
    B = batch["gt_item_id"].shape[0]
    n_sampled = num_neg * B * dp
    if n_sampled > log_probs.shape[0]:
        raise ValueError(
            f"unique negative sampling needs num_neg*batch ({n_sampled}) "
            f"<= num_item ({log_probs.shape[0]})")
    sampled = sample_negatives(generator, log_probs, n_sampled)
    sampled = sampled.long().reshape(B * dp, num_neg)[
        dp_index * B:(dp_index + 1) * B]

    tgt_item = torch.cat([batch["gt_item_id"][:, None].to(torch.int32),
                          item_ids[sampled].to(torch.int32)], dim=1)
    tgt_cate = torch.cat([batch["gt_cate_id"][:, None].to(torch.int32),
                          cate_ids[sampled].to(torch.int32)], dim=1)

    true_exp = expected_count(batch["weight_tag"], n_sampled)
    samp_exp = expected_count(probs[sampled], n_sampled)
    exp_cnt = torch.cat([true_exp[:, None], samp_exp], dim=1)
    log_exp_cnt = torch.log(1e-20 + exp_cnt)

    dev = log_probs.device
    labels = torch.cat([torch.ones((B, 1), device=dev),
                        torch.zeros((B, num_neg), device=dev)], dim=1)
    return {"item_id": tgt_item, "cate_id": tgt_cate,
            "labels": labels, "log_exp_cnt": log_exp_cnt}


def _mean(x: torch.Tensor, rows: Optional[int]) -> torch.Tensor:
    """x's mean over its first axis (and the rest), or with `rows` (the
    global batch's rows) this block's share of the global mean: its sum
    over the global count."""
    if rows is None:
        return x.mean()
    return x.sum() / (rows * (x[0].numel()))


def _sigmoid_xent(labels: torch.Tensor, logits: torch.Tensor,
                  rows: Optional[int] = None) -> torch.Tensor:
    """Mean elementwise sigmoid cross-entropy (tf.losses.sigmoid_cross_entropy
    with unit weights); with `rows`, this block's share over the global
    batch's rows."""
    per = torch.clamp(logits, min=0) - logits * labels + torch.log1p(
        torch.exp(-logits.abs()))
    return _mean(per, rows)


def _kl_with_logits(q_logit: torch.Tensor, p_logit: torch.Tensor,
                    rows: Optional[int] = None) -> torch.Tensor:
    """KL(softmax(q) || softmax(p)) averaged over rows, as JAX writes it;
    with `rows`, this block's share."""
    q = torch.softmax(q_logit, dim=-1)
    qlogq = _mean((q * torch.log_softmax(q_logit, dim=-1)).sum(-1), rows)
    qlogp = _mean((q * torch.log_softmax(p_logit, dim=-1)).sum(-1), rows)
    return qlogq - qlogp


def _accuracy(logits: torch.Tensor, labels: torch.Tensor,
              rows: Optional[int] = None) -> torch.Tensor:
    return _mean((logits.argmax(-1) == labels.argmax(-1)).float(), rows)


def nann_loss(params: Params, state: State, mcfg: ModelConfig,
              tcfg: TrainConfig, batch: Dict[str, torch.Tensor],
              targets: Dict[str, torch.Tensor], group=None,
              lookup: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, Tuple[State, Dict[str, torch.Tensor]]]:
    """Full training loss: (loss, (new_state, metrics)). The parameters must
    require grad: the FGSM term differentiates loss_xe by the item
    embeddings.

    With `group` (the "dp" process group; batch and targets this rank's
    block of the global batch) the returned loss is this rank's share of
    the global loss, to backprop on this rank, and the metrics are the
    global batch's on every rank. `lookup` looks up row-sharded tables."""
    rows = None
    if group is not None:
        rows = batch["gt_item_id"].shape[0] * dist.get_world_size(group)
    user_seq = scorer.user_embed(params, batch["item_ids"], batch["cate_ids"],
                                 lookup)
    item_emb, state1 = scorer.item_tower(
        params, state, mcfg, targets["item_id"], targets["cate_id"],
        training=True, group=group, lookup=lookup)

    labels = targets["labels"]
    log_exp_cnt = targets["log_exp_cnt"]

    # the xe pass: its new batch-norm state is the one the step keeps
    logits_origin, state2 = scorer.scorer_forward_train(
        params, state1, mcfg, user_seq, item_emb, group)
    logits = logits_origin - log_exp_cnt
    loss_xe = _sigmoid_xent(labels, logits, rows)

    if tcfg.adv_eps > 0:
        (emb_grad,) = torch.autograd.grad(loss_xe, item_emb,
                                          retain_graph=True)
        item_emb_adv = item_emb + tcfg.adv_eps * torch.sign(emb_grad)
        # Divergence guard (which BN state the step keeps): the adversarial
        # pass runs the head's batch norms in training mode too, and its new
        # state is discarded, as objective.py:95-121 discards it.
        logits_adv, _ = scorer.scorer_forward_train(
            params, state2, mcfg, user_seq, item_emb_adv, group)
        logits_adv = logits_adv - log_exp_cnt
        # the gradient stops at the clean logits only
        loss_adv = _kl_with_logits(logits.detach(), logits_adv, rows)
    else:
        loss_adv = torch.zeros((), device=logits.device)

    loss = loss_xe + tcfg.adv_weight * loss_adv
    metrics = {
        "loss": loss.detach(),
        "loss_xe": loss_xe.detach(),
        "loss_adv": loss_adv.detach(),
        "acc": _accuracy(logits.detach(), labels, rows),
        "acc_origin": _accuracy(logits_origin.detach(), labels, rows),
    }
    if group is not None:
        # the global batch's metrics: the ranks' shares summed
        names = ("loss_xe", "loss_adv", "acc", "acc_origin")
        shares = torch.stack([metrics[k] for k in names])
        dist.all_reduce(shares, op=dist.ReduceOp.SUM, group=group)
        metrics.update(zip(names, shares.unbind()))
        metrics["loss"] = metrics["loss_xe"] + \
            tcfg.adv_weight * metrics["loss_adv"]
    return loss, (state2, metrics)
