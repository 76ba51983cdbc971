"""COO -> compressed (CSC or CSR) topologies and bfloat16 features of an
IGBH-layout tree (counterpart of examples/igbh/compress_graph.py).

Reads ``<root>/processed/<src>__<rel>__<dst>/edge_index.npy`` and
``<root>/processed/<ntype>/node_feat.npy`` (``data.py``'s layout) and
writes::

    <root>/<layout>/<src>__<rel>__<dst>/compressed.npz   indptr, indices,
                                                         edge_ids
    <root>/<layout>/<ntype>/node_feat_bf16.npy           (with --bf16)

Each topology is the port's ``Topology`` of that layout, built on the card
(``--device cpu`` for the CPU); ``.npy`` holds no bfloat16, so a bf16
table is stored as the uint16 bit pattern of its ``torch.bfloat16`` cast,
which ``data.load_igbh_root`` reads back. ``--synthesize N`` first writes
the synthetic graph at N papers (``data.synthesize``): the chain
synthesize -> compress -> split_seeds -> dist_train_rgnn.

    python -m glt_tpu_torch.examples.igbh.compress_graph --path R
        [--layout CSC] [--bf16] [--synthesize PAPERS] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from glt_tpu_torch.data import Topology
from glt_tpu_torch.utils import resolve_device

from .data import load_meta, synthesize


def compress(root: str, layout: str = 'CSC', bf16: bool = False,
             topology: bool = True, device=None) -> None:
  """Each edge type's COO as a ``layout`` topology on ``device`` (default:
  the card), saved as ``compressed.npz``, and with ``bf16`` each node
  type's features as bfloat16 bits; ``topology=False`` writes only the
  features (a caller that partitions from the COO reads no
  topology)."""
  device = resolve_device(device)
  proc = os.path.join(root, 'processed')
  out_root = os.path.join(root, layout.lower())
  counts = load_meta(root)
  for name in (sorted(os.listdir(proc)) if topology else ()):
    path = os.path.join(proc, name, 'edge_index.npy')
    if not os.path.exists(path):
      continue
    s, _, d = name.split('__')
    ei = np.load(path)
    n_rows, n_cols = (d, s) if layout.upper() == 'CSC' else (s, d)
    topo = Topology(torch.as_tensor(ei, device=device),
                    layout=layout.upper(), num_rows=counts[n_rows],
                    num_cols=counts[n_cols])
    od = os.path.join(out_root, name)
    os.makedirs(od, exist_ok=True)
    np.savez(os.path.join(od, 'compressed.npz'),
             indptr=topo.indptr.cpu().numpy(),
             indices=topo.indices.cpu().numpy(),
             edge_ids=topo.edge_ids.cpu().numpy())
    print(f'{name}: {ei.shape[1]} edges -> {layout} '
          f'(indptr {topo.indptr.shape[0]})')
  if bf16:
    for t in counts:
      fp = os.path.join(proc, t, 'node_feat.npy')
      if os.path.exists(fp):
        feat = torch.from_numpy(np.load(fp)).to(device).to(torch.bfloat16)
        od = os.path.join(out_root, t)
        os.makedirs(od, exist_ok=True)
        np.save(os.path.join(od, 'node_feat_bf16.npy'),
                feat.view(torch.int16).cpu().numpy().view(np.uint16))
        print(f'{t}: features -> bf16 {tuple(feat.shape)}')


def main(argv: Optional[Sequence[str]] = None) -> None:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--path', required=True,
                  help='dataset root (IGBH on-disk layout)')
  ap.add_argument('--layout', default='CSC', choices=['CSC', 'CSR'])
  ap.add_argument('--bf16', action='store_true',
                  help='also compress features to bfloat16')
  ap.add_argument('--synthesize', type=int, default=0, metavar='PAPERS',
                  help='first write a synthetic IGBH-layout dataset at '
                       'this paper count')
  ap.add_argument('--seed', type=int, default=0)
  ap.add_argument('--device', default=None,
                  help='default: the card; "cpu" for the CPU')
  args = ap.parse_args(argv)
  if args.synthesize:
    synthesize(args.path, args.synthesize, seed=args.seed)
  compress(args.path, layout=args.layout, bf16=args.bf16,
           device=args.device)


if __name__ == '__main__':
  main()
