"""Superstep: K training steps as one unit (counterpart of
glt_tpu/ops/superstep.py).

The JAX package scans K batch bodies in one dispatch (``lax.scan``),
seeds and keys staged on the device, so the host pays one dispatch a
window instead of one a batch. The lift here is the plain loop over the
window's leading axis; on the card the trainer records the whole window
once in a ``torch.cuda.CUDAGraph`` (:func:`capture_window`) and replays
it for every later window of that length, its inputs in static buffers
filled before each replay. A body returns nothing it keeps between
batches (the walk allocates its dedup table a call), so a T-step window
equals T per-batch calls of the same body on the same inputs.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Tuple

import torch

from . import cuda_kernels


def tree_map(fn: Callable, tree):
  """``fn`` of every tensor of a tree of lists, tuples and dicts, in its
  structure (None stays None)."""
  if tree is None:
    return None
  if isinstance(tree, torch.Tensor):
    return fn(tree)
  if isinstance(tree, dict):
    return {k: tree_map(fn, v) for k, v in tree.items()}
  return type(tree)(tree_map(fn, v) for v in tree)


def tree_leaves(tree) -> Iterator[torch.Tensor]:
  """The tensors of a tree, in order."""
  if isinstance(tree, torch.Tensor):
    yield tree
  elif tree is not None:
    for v in (tree.values() if isinstance(tree, dict) else tree):
      yield from tree_leaves(v)


def _at(tree, t: int):
  """Step ``t`` of a tree of leading-axis tensors."""
  return tree_map(lambda x: x[t], tree)


def _length(tree) -> int:
  """The leading axis of the first tensor of a tree."""
  for x in tree_leaves(tree):
    return x.shape[0]
  raise ValueError('no tensor to take the window length from')


def _stack(items):
  """The per-step outputs stacked on a leading axis (tensors, or dicts of
  them; None stays None)."""
  first = items[0]
  if first is None:
    return None
  if isinstance(first, torch.Tensor):
    return torch.stack(items)
  if isinstance(first, dict):
    return {k: _stack([it[k] for it in items]) for k in first}
  return type(first)(_stack(list(v)) for v in zip(*items))


def superstep_hetero(batch_step: Callable) -> Callable:
  """Lift ``batch_step(state, seeds, n_valid, u) -> (state, aux)`` over a
  window: ``run(state, seeds_stack, n_valid_stack, u_stack) -> (state,
  aux_stack)``, step t reading ``seeds_stack[t]``, ``n_valid_stack[t]``
  and step t of every tensor in ``u_stack`` (a tree of ``[T, ...]``
  tensors, e.g. the per-hop uniforms). ``state`` is whatever the body
  threads between batches (None for the homogeneous body; the hetero
  trainer of ROADMAP A12 is its other caller). The one lift both bodies
  go through."""

  def run(state, seeds_stack, n_valid_stack, u_stack):
    aux = []
    for t in range(seeds_stack.shape[0]):
      state, a = batch_step(state, seeds_stack[t], n_valid_stack[t],
                            _at(u_stack, t))
      aux.append(a)
    return state, _stack(aux)

  return run


def superstep(batch_step: Callable) -> Callable:
  """Lift one training step ``batch_step(seeds, n_valid, u) -> aux``
  (sample, gather, forward, backward, update) over a window:
  ``run(seeds_stack, n_valid_stack, u_stack) -> aux_stack``; the
  stateless case of :func:`superstep_hetero`."""
  run_tree = superstep_hetero(
      lambda state, seeds, n_valid, u: (state, batch_step(seeds, n_valid,
                                                          u)))

  def run(seeds_stack, n_valid_stack, u_stack):
    return run_tree(None, seeds_stack, n_valid_stack, u_stack)[1]

  return run


def scan_consume(consume_step: Callable) -> Callable:
  """Lift a body over pre-sampled inputs, ``consume_step(carry, x) ->
  (carry, aux)``, over a window: ``run(carry, xs) -> (carry,
  aux_stack)`` with ``xs`` a tree of ``[T, ...]`` tensors (the cold
  streaming trainer's sampled batches and staged cold rows)."""

  def run(carry, xs):
    aux = []
    for t in range(_length(xs)):
      carry, a = consume_step(carry, _at(xs, t))
      aux.append(a)
    return carry, _stack(aux)

  return run


def capture_window(run: Callable[[], Any], device: torch.device
                   ) -> Tuple[Any, torch.cuda.CUDAGraph, Any, float,
                              Dict[str, int]]:
  """Run a window's body ``run()`` (which reads its inputs from static
  buffers) once eagerly on a side stream, its real work, which also
  creates the optimizer's state and the libraries' handles; then record
  it in a CUDA graph. Returns ``(eager outputs, graph, the graph's
  output tensors, seconds of the capture, kernel launches recorded in
  the graph by wrapper name)``: each replay launches those again. The
  backward passes allocate their gradients in the graph's private pool.
  A capture that fails raises (nothing runs the window another way)."""
  current = torch.cuda.current_stream(device)
  side = torch.cuda.Stream(device)
  side.wait_stream(current)
  with torch.cuda.stream(side):
    out = run()
  current.wait_stream(side)
  torch.cuda.synchronize(device)
  # the eager window's cached blocks go back to the card before the
  # graph's private pool fills: at igbh-rgat's width one body's peak is
  # over half the card, and the two would not fit together
  torch.cuda.empty_cache()
  before = {fn.__name__: fn.recorded for fn in cuda_kernels.KERNELS}
  t0 = time.perf_counter()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.device(device), torch.cuda.graph(graph):
    static_out = run()
  torch.cuda.synchronize(device)
  secs = time.perf_counter() - t0
  recorded = {fn.__name__: fn.recorded - before[fn.__name__]
              for fn in cuda_kernels.KERNELS}
  return out, graph, static_out, secs, recorded
