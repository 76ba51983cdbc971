"""The port's examples/igbh/compress_graph.py (glt_tpu_torch.examples.igbh.
compress_graph) against the JAX example's ``compress`` on the same
synthesized tree: the same ``compressed.npz`` arrays (dtypes included) in
both layouts, the bf16 tables' bits equal to ml_dtypes' cast (only this
test imports ml_dtypes), ``load_igbh_root`` reading them back as
``torch.bfloat16`` where JAX reads ml_dtypes bfloat16, and the port's
``main`` taking the JAX flags."""
import importlib.util
import os
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from glt_tpu_torch.examples.igbh import compress_graph, data

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'examples', 'igbh')
PAPERS = 600


def _jax_module(name):
  """A module of examples/igbh (it imports its siblings by bare name)."""
  sys.path.insert(0, EXAMPLES)
  try:
    spec = importlib.util.spec_from_file_location(
        f'jax_igbh_{name}', os.path.join(EXAMPLES, f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
  finally:
    sys.path.remove(EXAMPLES)


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
  """One synthesized tree compressed by each package, both layouts."""
  jax_cg = _jax_module('compress_graph')
  out = {}
  for pkg in ('jax', 'port'):
    root = str(tmp_path_factory.mktemp(pkg))
    data.synthesize(root, PAPERS, seed=3)
    data.split_seeds(root)
    for layout in ('CSC', 'CSR'):
      if pkg == 'jax':
        jax_cg.compress(root, layout=layout, bf16=layout == 'CSC')
      else:
        compress_graph.compress(root, layout=layout, bf16=layout == 'CSC',
                                device='cpu')
    out[pkg] = root
  return out


@pytest.mark.parametrize('layout', ['csc', 'csr'])
def test_compressed_topologies_match_jax(trees, layout):
  names = sorted(os.listdir(os.path.join(trees['jax'], layout)))
  etypes = [n for n in names if '__' in n]
  assert len(etypes) == 3
  assert names == sorted(os.listdir(os.path.join(trees['port'], layout)))
  for name in etypes:
    with np.load(os.path.join(trees['jax'], layout, name,
                              'compressed.npz')) as w, \
         np.load(os.path.join(trees['port'], layout, name,
                              'compressed.npz')) as g:
      assert g.files == w.files == ['indptr', 'indices', 'edge_ids']
      for k in w.files:
        assert g[k].dtype == w[k].dtype, (name, k)
        np.testing.assert_array_equal(g[k], w[k], err_msg=f'{name} {k}')


def test_bf16_tables_match_ml_dtypes(trees):
  proc = os.path.join(trees['port'], 'processed')
  for t in data.load_meta(trees['port']):
    got = np.load(os.path.join(trees['port'], 'csc', t, 'node_feat_bf16.npy'))
    want = np.load(os.path.join(proc, t, 'node_feat.npy')).astype(
        ml_dtypes.bfloat16).view(np.uint16)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    assert (open(os.path.join(trees['port'], 'csc', t, 'node_feat_bf16.npy'),
                 'rb').read() == open(os.path.join(
                     trees['jax'], 'csc', t, 'node_feat_bf16.npy'),
                     'rb').read())
  assert not os.path.exists(os.path.join(trees['port'], 'csr', 'paper',
                                         'node_feat_bf16.npy'))


def test_load_igbh_root_reads_bf16_as_jax(trees):
  jax_rgnn = _jax_module('dist_train_rgnn')
  want = jax_rgnn.load_igbh_root(trees['jax'])
  got = data.load_igbh_root(trees['port'])
  assert got[0] == want[0]
  assert sorted(got[1]) == sorted(want[1])
  for e in want[1]:
    np.testing.assert_array_equal(got[1][e], want[1][e])
  for t, w in want[2].items():
    assert got[2][t].dtype == torch.bfloat16
    np.testing.assert_array_equal(got[2][t].view(torch.int16).numpy(),
                                  w.view(np.int16))
  for a, b in zip(got[3:], want[3:]):
    np.testing.assert_array_equal(a, b)


def test_main_synthesizes_and_compresses(tmp_path):
  compress_graph.main(['--path', str(tmp_path), '--synthesize', '300',
                       '--layout', 'CSR', '--bf16', '--device', 'cpu'])
  assert os.path.exists(tmp_path / 'csr' / 'paper__cites__paper' /
                        'compressed.npz')
  assert np.load(tmp_path / 'csr' / 'author' /
                 'node_feat_bf16.npy').shape == (150, 128)
