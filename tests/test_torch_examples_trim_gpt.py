"""The port's trim and GPT-on-graphs examples
(glt_tpu_torch/examples/train_sage_with_trim.py, gpt_on_graphs.py)
against the JAX package's (examples/train_sage_with_trim.py,
examples/gpt_on_graphs.py) on the same numpy inputs:

- trimmed and untrimmed GraphSAGE logits on one loader batch of the trim
  example's graph, the port's model given the flax parameters, within
  1e-5 (float32 sums in another order);
- the trim example's ``main`` on the CPU at ``--nodes 1000``, its
  accuracy check included;
- ``synth_titled_citations``: the same graph and titles;
- ``ego_prompt``: the same strings for the same batches, the port's
  loader taking the JAX sampler's draws (the negatives' proposals and the
  walk's uniforms) from the key the JAX sampler split for each batch.
"""
import jax
import numpy as np
import pytest
import torch

from examples import gpt_on_graphs as jax_gpt
from examples.common import synthetic_products as jax_synthetic_products
from glt_tpu.loader import LinkNeighborLoader as JaxLinkNeighborLoader
from glt_tpu.loader import NeighborLoader as JaxNeighborLoader
from glt_tpu.models import GraphSAGE as JaxGraphSAGE
from glt_tpu.sampler import NegativeSampling as JaxNegativeSampling
from glt_tpu_torch.examples import gpt_on_graphs as gpt
from glt_tpu_torch.examples import train_sage_with_trim as trim_example
from glt_tpu_torch.loader.transform import Batch
from glt_tpu_torch.models import GraphSAGE, sage_params_from_flax
from test_torch_link import _proposals
from test_torch_sampler_options import homo_uniforms_from_key

TOL = 1e-5


def _np(x):
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the trim example -----------------------------------------------------------

def test_trimmed_and_untrimmed_logits_match_jax(monkeypatch):
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  jds, classes = jax_synthetic_products(num_nodes=600)
  fanout = [5, 3, 2]
  jb = next(iter(JaxNeighborLoader(jds, fanout,
                                   input_nodes=jds.get_split('train'),
                                   batch_size=32, shuffle=True, seed=0,
                                   rng=np.random.default_rng(0))))
  pb = Batch(x=torch.as_tensor(np.array(jb.x)), batch_size=jb.batch_size,
             edge_hop_offsets=tuple(jb.edge_hop_offsets),
             **{f: torch.as_tensor(np.array(getattr(jb, f)))
                for f in ('row', 'col', 'edge_mask', 'node', 'node_count')})
  for trim in (True, False):
    model = JaxGraphSAGE(hidden_features=32, out_features=classes,
                         num_layers=len(fanout), trim=trim)
    params = jax.jit(model.init)(jax.random.key(0), jb)
    want = np.asarray(jax.jit(model.apply)(params, jb))
    port = GraphSAGE(jb.x.shape[1], 32, classes, num_layers=len(fanout),
                     trim=trim)
    port.load_state_dict(sage_params_from_flax(
        jax.tree.map(np.asarray, params)))
    with torch.no_grad():
      got = port(pb).numpy()
    assert got.shape == want.shape == (32, classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                               err_msg=f'trim={trim}')
  # trimming drops edge slots of the deep hops from the shallow layers
  slots = trim_example.layer_slots(pb.edge_hop_offsets, pb.row.numel(), 3,
                                   True)
  assert slots == [pb.row.numel(), pb.edge_hop_offsets[2],
                   pb.edge_hop_offsets[1]]
  assert trim_example.layer_slots(pb.edge_hop_offsets, pb.row.numel(), 3,
                                  False) == [pb.row.numel()] * 3


def test_trim_example_main_on_the_cpu(capsys):
  res = trim_example.main(['--device', 'cpu', '--nodes', '1000',
                           '--fanout', '10,5', '--batch-size', '128'])
  lines = capsys.readouterr().out.splitlines()
  assert lines[0] == (f'edge buffer {res["slots"]} slots; per-layer trim '
                      f'offsets {res["offsets"]}')
  assert lines[1].startswith('trim=True : loss=')
  assert lines[2].startswith('trim=False: loss=')
  assert lines[-1] == 'done' and len(lines) == 4
  t, f = res[True], res[False]
  # 800 training nodes, batches of 128: 7 steps a trajectory
  assert len(t['step_ms']) == len(f['step_ms']) == 7
  assert abs(t['acc'] - f['acc']) < 0.15
  assert np.isfinite(t['loss']) and np.isfinite(f['loss'])
  assert t['layer_slots'] == [res['offsets'][2], res['offsets'][1]]
  assert f['layer_slots'] == [res['slots']] * 2


def test_trim_example_needs_a_device_without_a_card():
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default device is the card')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    trim_example.main(['--nodes', '100'])


# -- GPT on graphs --------------------------------------------------------------

def test_synth_titled_citations_matches_jax():
  jds, jtitles = jax_gpt.synth_titled_citations(500)
  ds, titles = gpt.synth_titled_citations(500, device='cpu')
  np.testing.assert_array_equal(titles, jtitles)
  jg, g = jds.get_graph(), ds.get_graph()
  assert g.num_nodes == jg.num_nodes == 500
  for f in ('indptr', 'indices'):
    np.testing.assert_array_equal(_np(getattr(g, f)),
                                  np.asarray(getattr(jg, f)), err_msg=f)
  np.testing.assert_array_equal(_np(g.topo.edge_ids),
                                np.asarray(jg.topo.edge_ids))


def test_ego_prompts_match_jax(monkeypatch):
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  fanout = [12, 6]
  jds, titles = jax_gpt.synth_titled_citations(400)
  ds, _ = gpt.synth_titled_citations(400, device='cpu')
  # the JAX example's loader
  jl = JaxLinkNeighborLoader(
      jds, fanout, batch_size=2, shuffle=True, drop_last=True, seed=0,
      neg_sampling=JaxNegativeSampling('binary', amount=1),
      collect_features=False)
  js = jl.sampler
  keys, jax_sample = [], js.sample_from_edges

  def record_key(inputs):
    keys.append(js._next_key())
    return jax_sample(inputs, key=keys[-1])
  js.sample_from_edges = record_key
  pl = gpt.prompt_loader(ds, fanout, 'cpu')
  ps = pl.sampler
  real = ps.sample_from_edges

  def sample_from_edges(inputs):
    # 2 positives and 2 binary negatives: 8 seeds
    kneg, kwalk = jax.random.split(keys[-1])
    return real(inputs, proposals=_proposals(kneg, 2, ps.graph),
                uniforms=homo_uniforms_from_key(kwalk, 8, ps))
  ps.sample_from_edges = sample_from_edges
  assert len(pl) == len(jl)
  n = 0
  for jb, pb in zip(jl, pl):
    assert pb.x is None and jb.x is None
    want, got = jax_gpt.ego_prompt(jb, titles), gpt.ego_prompt(pb, titles)
    assert got == want
    assert got.count('->') > 3 and '[0]' in got
    n += 1
    if n == 3:
      break
  assert n == 3


def test_gpt_example_main_prints_prompts(capsys):
  prompts = gpt.main(['--device', 'cpu', '--papers', '300',
                      '--num-batches', '2'])
  out = capsys.readouterr().out
  assert len(prompts) == 2 and all(p in out for p in prompts)
  assert out.count('=== batch ') == 2 and out.rstrip().endswith('done')


def test_gpt_example_model_needs_transformers(monkeypatch):
  # --model imports transformers lazily: without it, the JAX example's
  # ImportError
  import sys
  monkeypatch.setitem(sys.modules, 'transformers', None)
  with pytest.raises(ImportError):
    gpt.main(['--device', 'cpu', '--papers', '100', '--num-batches', '1',
              '--model', '/nonexistent'])
