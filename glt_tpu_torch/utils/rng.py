"""Seed management (counterpart of glt_tpu/utils/rng.py).

A process-wide base seed, as in the reference's ``RandomSeedManager``;
each sampler owns a ``torch.Generator`` on its device seeded from it, so
samplers never share a stream and a run is reproducible from one seed.
``jax.random`` streams cannot be reproduced in torch: tests that compare
with the JAX package inject the JAX draws instead.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch


def make_generator(seed: int, device: torch.device) -> torch.Generator:
  gen = torch.Generator(device=device)
  gen.manual_seed(int(seed))
  return gen


class RandomSeedManager:
  _instance = None
  _lock = threading.Lock()

  def __init__(self):
    self._seed = 42
    self._local = threading.Lock()

  @classmethod
  def getInstance(cls) -> 'RandomSeedManager':
    with cls._lock:
      if cls._instance is None:
        cls._instance = cls()
      return cls._instance

  def setSeed(self, seed: int) -> None:
    with self._local:
      self._seed = int(seed)

  def getSeed(self) -> int:
    with self._local:
      return self._seed


def seeded_state_dict(model: torch.nn.Module,
                      seed: int) -> Dict[str, torch.Tensor]:
  """Weights for every entry of ``model``'s state_dict drawn from
  ``seed``: uniform in +-1/sqrt(fan_in) (nn.Linear's default range; a bias
  takes its weight's fan-in, a weight or an attention vector its last
  axis), drawn on the CPU so that a seed gives the same weights on every
  device."""
  gen = torch.Generator().manual_seed(int(seed))
  state, current = {}, model.state_dict()
  for name, p in current.items():
    fan_in = (current[name[:-len('bias')] + 'weight'].shape[-1]
              if name.endswith('bias') else p.shape[-1])
    bound = 1.0 / float(fan_in) ** 0.5
    state[name] = (torch.rand(p.shape, generator=gen) * 2 - 1) * bound
  return state
