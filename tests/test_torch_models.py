"""The port's SAGEConv / GraphSAGE against the flax models with converted
parameters, float32 on the CPU.

Tolerance rtol = atol = 1e-5: the two frameworks sum the neighbour
messages and the matmul products in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from glt_tpu.loader.transform import Batch as JaxBatch
from glt_tpu.models.conv import SAGEConv as JaxSAGEConv
from glt_tpu.models.sage import GraphSAGE as JaxGraphSAGE
from glt_tpu_torch.loader import Batch
from glt_tpu_torch.models import (GraphSAGE, SAGEConv, segment_mean,
                                  sage_conv_params_from_flax,
                                  sage_params_from_flax)

TOL = dict(rtol=1e-5, atol=1e-5)


def _padded_edges(rng, n_nodes, n_edges):
  row = rng.integers(0, n_nodes, n_edges).astype(np.int32)
  col = rng.integers(0, n_nodes, n_edges).astype(np.int32)
  mask = rng.random(n_edges) < 0.8
  row[~mask] = -1  # padded lanes carry -1 children, as the sampler emits
  return row, col, mask


def _np_tree(params):
  return jax.tree.map(np.asarray, params)


def test_segment_mean_matches_jax():
  from glt_tpu.models.conv import segment_mean as jax_segment_mean
  rng = np.random.default_rng(0)
  msgs = rng.standard_normal((50, 6)).astype(np.float32)
  tgt = rng.integers(0, 9, 50).astype(np.int32)
  mask = rng.random(50) < 0.7
  want = jax_segment_mean(jnp.asarray(msgs), jnp.asarray(tgt),
                          jnp.asarray(mask), 9)
  got = segment_mean(torch.as_tensor(msgs), torch.as_tensor(tgt),
                     torch.as_tensor(mask), 9)
  np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)


def test_sage_conv_matches_flax():
  rng = np.random.default_rng(1)
  x = rng.standard_normal((40, 16)).astype(np.float32)
  row, col, mask = _padded_edges(rng, 40, 120)
  conv = JaxSAGEConv(24)
  args = tuple(jnp.asarray(a) for a in (x, row, col, mask))
  params = conv.init(jax.random.key(0), *args)
  want = conv.apply(params, *args)
  port = SAGEConv(16, 24)
  port.load_state_dict(sage_conv_params_from_flax(
      _np_tree(params)['params']))
  with torch.no_grad():
    got = port(*(torch.as_tensor(a) for a in (x, row, col, mask)))
  np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)


def test_graphsage_matches_flax_with_trimming():
  # a sampler-shaped batch: batch 4, fanouts (3, 2), hop-ordered edges
  rng = np.random.default_rng(2)
  b, fanouts = 4, (3, 2)
  offsets = [0, 12, 36]
  n_nodes = 4 + 12 + 24
  x = rng.standard_normal((n_nodes, 10)).astype(np.float32)
  row, col, mask = _padded_edges(rng, n_nodes, offsets[-1])
  fields = dict(row=row, col=col, edge_mask=mask,
                node=np.arange(n_nodes, dtype=np.int32),
                node_count=np.int32(n_nodes))
  for trim in (True, False):
    model = JaxGraphSAGE(hidden_features=32, out_features=7, num_layers=3,
                         trim=trim)
    jb = JaxBatch(x=jnp.asarray(x), batch_size=b,
                  edge_hop_offsets=tuple(offsets),
                  **{k: jnp.asarray(v) for k, v in fields.items()})
    params = model.init(jax.random.key(3), jb)
    want = model.apply(params, jb)
    port = GraphSAGE(10, 32, 7, num_layers=3, trim=trim)
    port.load_state_dict(sage_params_from_flax(_np_tree(params)))
    pb = Batch(x=torch.as_tensor(x), batch_size=b,
               edge_hop_offsets=tuple(offsets),
               **{k: torch.as_tensor(v) for k, v in fields.items()})
    with torch.no_grad():
      got = port(pb)
    assert got.shape == (b, 7)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL,
                               err_msg=f'trim={trim}')
