"""The training step on one device, for GraphSAGE over a Batch and RGNN
over a HeteroBatch (counterpart of ``_sage_update`` in
glt_tpu/parallel/train.py, without its ``pmean``: the data-parallel step
over several cards waits for the distributed port; of the step of
examples/hetero/train_rgnn.py; and, with ``loss=link_bce_loss``, of the
unsupervised link-prediction step of examples/graph_sage_unsup.py).

The loss is the masked softmax cross-entropy of the seed rows, averaged
over the ``n_valid`` real seeds of the batch; autograd through the
model's ``index_add_`` and ``scatter_reduce`` aggregations carries the
gradient (no Pallas kernel of the JAX package has a backward);
``torch.optim.Adam`` applies it with
optax's ``adam`` defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0). The
three stages carry ``torch.profiler`` ranges (``train.forward``,
``train.backward``, ``train.optimizer``); with ``sync_stages`` each of
them starts and ends in a device sync, so that a trace can attribute the
kernels that ran inside a range's host interval to its stage, the
backward's too (autograd launches those from its own thread, outside the
range's device-side extent).
"""
from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..loader.transform import Batch, HeteroBatch


def sage_loss(model: nn.Module,
              batch: Union[Batch, HeteroBatch]) -> torch.Tensor:
  """Mean cross-entropy of the logits against the seed labels (``batch.y``
  of a Batch, ``batch.y_dict[batch.input_type]`` of a HeteroBatch) over
  the first ``batch.metadata['n_valid']`` seeds (padded seeds weigh
  nothing)."""
  logits = model(batch)
  y = (batch.y_dict[batch.input_type] if isinstance(batch, HeteroBatch)
       else batch.y)
  n = logits.shape[0]
  mask = torch.arange(n, device=logits.device) < batch.metadata['n_valid']
  losses = F.cross_entropy(logits, y.long(), reduction='none')
  return (torch.where(mask, losses, torch.zeros_like(losses)).sum()
          / mask.sum().clamp(min=1))


def link_bce_loss(model: nn.Module, batch: Batch) -> torch.Tensor:
  """The link-prediction loss of examples/graph_sage_unsup.py: every
  sampled node's embedding (``model.embed``), a dot product per labelled
  pair of ``metadata['edge_label_index']``, and the sigmoid binary
  cross-entropy against ``metadata['edge_label']``, averaged over every
  label slot (a padded ragged batch's repeated edges included, as the
  example averages them)."""
  emb = model.embed(batch)
  eli = batch.metadata['edge_label_index'].long()
  logit = (emb.index_select(0, eli[0]) * emb.index_select(0, eli[1])).sum(-1)
  label = batch.metadata['edge_label'].to(logit.dtype)
  return F.binary_cross_entropy_with_logits(logit, label)


class SageTrainStep:
  """One forward/backward/Adam update of ``model`` per call.

  Args:
    model: a module consuming a Batch (models.GraphSAGE) or a HeteroBatch
      (models.RGNN).
    lr: Adam's learning rate (the reference's 1e-3).
    sync_stages: synchronise the card around every stage (for profiling;
      a no-op for a model on the CPU).
    loss: ``loss(model, batch)`` -> scalar (default :func:`sage_loss`;
      :func:`link_bce_loss` for link prediction).
  """

  def __init__(self, model: nn.Module, lr: float = 1e-3,
               sync_stages: bool = False,
               loss: Callable[[nn.Module, Batch], torch.Tensor] = sage_loss):
    self.model = model
    self.loss = loss
    self.optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                      betas=(0.9, 0.999), eps=1e-8)
    device = next(model.parameters()).device
    self._sync = (lambda: torch.cuda.synchronize(device)) if (
        sync_stages and device.type == 'cuda') else (lambda: None)

  def __call__(self, batch: Union[Batch, HeteroBatch]) -> torch.Tensor:
    """Returns the batch's loss (before the update), detached."""
    self.optimizer.zero_grad(set_to_none=True)
    self._sync()
    with record_function('train.forward'):
      loss = self.loss(self.model, batch)
      self._sync()
    with record_function('train.backward'):
      loss.backward()
      self._sync()
    with record_function('train.optimizer'):
      self.optimizer.step()
      self._sync()
    return loss.detach()
