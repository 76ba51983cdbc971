"""GPT on graphs: ego subgraphs as link-prediction prompts (counterpart of
examples/gpt_on_graphs.py, the reference's examples/gpt/arxiv.py
workload). A LinkNeighborLoader samples the joint neighbourhood of
candidate paper pairs (fanouts [12, 6], binary negatives, batch 2), the
node ids map back to titles, and the sampled ego subgraph becomes a
prompt asking whether the two seed papers cite each other.

Nothing can be downloaded here, so the graph and its titles are
synthetic (a word pool standing in for arxiv_2023's titles.csv.gz, the
JAX example's numpy draws), and the prompts are printed; ``--model
<local dir>`` scores them with a locally available causal LM through
``transformers`` (the reference calls the OpenAI API at that point).

    python -m glt_tpu_torch.examples.gpt_on_graphs [--papers 2000]
        [--num-batches 3] [--fanout 12,6] [--model DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import itertools
from typing import List, Optional, Sequence

import numpy as np

from glt_tpu_torch.data import Dataset
from glt_tpu_torch.loader import LinkNeighborLoader
from glt_tpu_torch.sampler import NegativeSampling
from glt_tpu_torch.utils import as_numpy, resolve_device

_ADJ = ('Scalable', 'Sparse', 'Neural', 'Sampled', 'Distributed',
        'Quantized', 'Streaming', 'Robust', 'Latent', 'Causal')
_NOUN = ('Graph Learning', 'Attention', 'Message Passing', 'Embeddings',
         'Link Prediction', 'Clustering', 'Transformers', 'Sampling',
         'Partitioning', 'Representation Learning')
_TAIL = ('at Scale', 'on TPUs', 'with Negative Sampling', 'for Citations',
         'under Distribution Shift', 'in Heterogeneous Networks',
         'with Frontier Trimming', 'via Collectives', 'for MAG',
         'with Hot Caches')


def synth_titled_citations(num_papers: int, avg_cites: int = 6,
                           seed: int = 0, device=None):
  """A citation graph (self-citations dropped) on ``device`` and a title a
  paper, from the JAX example's numpy draws. Returns ``(dataset,
  titles)``."""
  rng = np.random.default_rng(seed)
  e = num_papers * avg_cites
  src = rng.integers(0, num_papers, e, dtype=np.int64)
  dst = (rng.random(e) ** 2 * num_papers).astype(np.int64) % num_papers
  keep = src != dst
  ds = Dataset(edge_dir='out')
  ds.init_graph(np.stack([src[keep], dst[keep]]), num_nodes=num_papers,
                device=device)
  ids = rng.integers(0, len(_ADJ), size=(num_papers, 3))
  titles = np.array(
      [f'{_ADJ[a]} {_NOUN[b % len(_NOUN)]} {_TAIL[c % len(_TAIL)]}'
       for a, b, c in ids])
  return ds, titles


def ego_prompt(batch, titles: np.ndarray) -> str:
  """One sampled ego subgraph as a link-prediction prompt (the
  reference's utils.link_prediction message): the sampled papers by local
  label, the valid sampled edges (citing -> cited) and the question about
  the batch's first labelled pair."""
  node = as_numpy(batch.node)
  mask = as_numpy(batch.edge_mask).astype(bool)
  row = as_numpy(batch.row)[mask]
  col = as_numpy(batch.col)[mask]
  eli = as_numpy(batch.metadata['edge_label_index'])
  lines = ['You are given a citation subgraph. Papers:']
  for local, gid in enumerate(node[:int(as_numpy(batch.node_count))]):
    lines.append(f'  [{local}] "{titles[gid]}"')
  lines.append('Known citations (citing -> cited):')
  for r, c in zip(row.tolist(), col.tolist()):
    lines.append(f'  [{r}] -> [{c}]')
  a, b = int(eli[0][0]), int(eli[1][0])
  lines.append(
      f'Question: based only on the structure above, is paper [{a}] '
      f'likely to cite paper [{b}]? Answer yes or no with one reason.')
  return '\n'.join(lines)


def prompt_loader(ds, fanout, device, seed: int = 0) -> LinkNeighborLoader:
  """The example's loader: every citation a candidate, batch 2 with one
  binary negative each, shuffled, no features gathered."""
  return LinkNeighborLoader(
      ds, list(fanout), batch_size=2, shuffle=True, drop_last=True,
      seed=seed, neg_sampling=NegativeSampling('binary', amount=1),
      collect_features=False, device=device)


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--papers', type=int, default=2_000)
  ap.add_argument('--num-batches', type=int, default=3)
  ap.add_argument('--fanout', default='12,6')
  ap.add_argument('--model', default=None,
                  help='a local causal-LM directory; omit to print the '
                  'prompts only (nothing is downloaded)')
  ap.add_argument('--max-new-tokens', type=int, default=48)
  ap.add_argument('--device', default=None,
                  help='default: the card (cpu runs the plain versions)')
  args = ap.parse_args(argv)
  device = resolve_device(args.device)

  ds, titles = synth_titled_citations(args.papers, device=device)
  loader = prompt_loader(ds, [int(f) for f in args.fanout.split(',')],
                         device)
  generate = None
  if args.model:
    # imported only when asked: the weights must be local
    from transformers import pipeline
    generate = pipeline('text-generation', model=args.model, device=-1)

  prompts = []
  # islice: no batch is sampled past the last one printed
  for i, batch in enumerate(itertools.islice(loader, args.num_batches)):
    prompt = ego_prompt(batch, titles)
    prompts.append(prompt)
    label = float(as_numpy(batch.metadata['edge_label'])[0])
    print(f'=== batch {i} (label={label:.0f})')
    print(prompt)
    if generate is not None:
      out = generate(prompt, max_new_tokens=args.max_new_tokens,
                     do_sample=False)[0]['generated_text']
      print(f'--- model response:\n{out[len(prompt):]}')
  print('done')
  return prompts


if __name__ == '__main__':
  main()
