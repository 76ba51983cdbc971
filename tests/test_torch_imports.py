"""The port stands alone: importing every module of ``glt_tpu_torch`` (the
hetero models, loader and typing, the live-update stream, and the
training slice's loaders, train step and profiling among them, the
probe and microbench kernels and their benchmark entry points, and the
link and SEAL modules with their two example scripts, and the hot/cold
feature tier's offload, reorder, products example and feature bench, and
the superstep trainer's mesh, collectives, sharded feature store,
superstep lifts, epoch staging, prefetch thread and training bench, and
the partitioned slice's partitioner, distributed stores, samplers and
trainer, MLPerf logging and the IGBH example, and HGT with the four
hetero examples, and the homogeneous partitioned trainer, loaders,
negative sampler and the two distributed examples, and the server-client
slice's channels, shared-memory ring, resilience, rpc fabric, contexts,
options, event loop, producers, server, client, channel loaders and its
two examples, and the serving front ends' observability layer, env knobs,
timer, checkpoints, metrics, batcher, server, fleet and serving example,
and the live-update slice's fault injection and stream example, and the
data sources' table dataset, fragment loaders, online partitioners,
multihost builders, row-index helpers and their two examples)
and ``chip_smoke`` pulls in neither JAX, ``ml_dtypes`` nor
the JAX package, and touches no card; the shared-memory ring the port
loads is its own build."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import importlib, pkgutil, sys
import glt_tpu_torch
for m in pkgutil.walk_packages(glt_tpu_torch.__path__, 'glt_tpu_torch.'):
  importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'glt_tpu',
                                    'ml_dtypes'))
print('LOADED', len([m for m in sys.modules if m.startswith('glt_tpu_torch')]))
print('BAD', bad)
print('HETERO', all(m in sys.modules for m in (
    'glt_tpu_torch.models.rgnn', 'glt_tpu_torch.models.convert',
    'glt_tpu_torch.loader.transform', 'glt_tpu_torch.typing')))
print('STREAM', all(m in sys.modules for m in (
    'glt_tpu_torch.stream', 'glt_tpu_torch.stream.delta',
    'glt_tpu_torch.stream.snapshot', 'glt_tpu_torch.stream.sampler',
    'glt_tpu_torch.stream.ingest', 'glt_tpu_torch.ops.delta')))
print('TRAIN', all(m in sys.modules for m in (
    'glt_tpu_torch.loader.node_loader', 'glt_tpu_torch.loader.neighbor_loader',
    'glt_tpu_torch.loader.device_epoch', 'glt_tpu_torch.parallel.train',
    'glt_tpu_torch.utils.profile')))
print('LINK', all(m in sys.modules for m in (
    'glt_tpu_torch.examples.graph_sage_unsup',
    'glt_tpu_torch.examples.seal_link_pred', 'glt_tpu_torch.ops.negative',
    'glt_tpu_torch.ops.subgraph', 'glt_tpu_torch.ops.drnl',
    'glt_tpu_torch.loader.link_loader', 'glt_tpu_torch.loader.subgraph_loader',
    'glt_tpu_torch.models.dgcnn')))
print('BENCH', all(m in sys.modules for m in (
    'glt_tpu_torch.benchmarks.probe_compile',
    'glt_tpu_torch.benchmarks.microbench_gather',
    'glt_tpu_torch.ops.probe_kernels')))
print('TIER', all(m in sys.modules for m in (
    'glt_tpu_torch.utils.offload', 'glt_tpu_torch.data.reorder',
    'glt_tpu_torch.examples.common',
    'glt_tpu_torch.examples.train_sage_products',
    'glt_tpu_torch.benchmarks.bench_feature')))
print('SUPERSTEP', all(m in sys.modules for m in (
    'glt_tpu_torch.parallel.mesh', 'glt_tpu_torch.parallel.collectives',
    'glt_tpu_torch.parallel.dist_feature', 'glt_tpu_torch.ops.superstep',
    'glt_tpu_torch.loader.device_epoch', 'glt_tpu_torch.utils.prefetch',
    'glt_tpu_torch.benchmarks.bench_train')))
print('DIST', all(m in sys.modules for m in (
    'glt_tpu_torch.partition', 'glt_tpu_torch.partition.base',
    'glt_tpu_torch.partition.partition_book',
    'glt_tpu_torch.partition.random_partitioner',
    'glt_tpu_torch.distributed', 'glt_tpu_torch.distributed.dist_dataset',
    'glt_tpu_torch.distributed.dist_graph',
    'glt_tpu_torch.distributed.dist_neighbor_sampler',
    'glt_tpu_torch.distributed.dist_feature',
    'glt_tpu_torch.distributed.dist_hetero',
    'glt_tpu_torch.utils.mlperf_logging',
    'glt_tpu_torch.examples.igbh.data',
    'glt_tpu_torch.examples.igbh.dist_train_rgnn')))
print('DIST_HOMO', all(m in sys.modules for m in (
    'glt_tpu_torch.distributed.dist_train',
    'glt_tpu_torch.distributed.dist_loader',
    'glt_tpu_torch.distributed.dist_negative',
    'glt_tpu_torch.distributed.dist_link_loader',
    'glt_tpu_torch.distributed.dist_subgraph_loader',
    'glt_tpu_torch.examples.distributed',
    'glt_tpu_torch.examples.distributed.common',
    'glt_tpu_torch.examples.distributed.dist_train_sage',
    'glt_tpu_torch.examples.distributed.dist_sage_unsup')))
print('HGT', all(m in sys.modules for m in (
    'glt_tpu_torch.models.hgt', 'glt_tpu_torch.examples.hetero',
    'glt_tpu_torch.examples.hetero.bipartite_sage_unsup',
    'glt_tpu_torch.examples.hetero.train_hgt_mag',
    'glt_tpu_torch.examples.hetero.train_rgnn',
    'glt_tpu_torch.examples.hetero.hierarchical_sage')))
print('SERVER_CLIENT', all(m in sys.modules for m in (
    'glt_tpu_torch.channel', 'glt_tpu_torch.channel.base',
    'glt_tpu_torch.channel.shm', 'glt_tpu_torch.channel.shm_channel',
    'glt_tpu_torch.channel.mp_channel',
    'glt_tpu_torch.channel.remote_channel',
    'glt_tpu_torch.resilience', 'glt_tpu_torch.resilience.retry',
    'glt_tpu_torch.resilience.health',
    'glt_tpu_torch.distributed.rpc', 'glt_tpu_torch.distributed.dist_context',
    'glt_tpu_torch.distributed.dist_options',
    'glt_tpu_torch.distributed.event_loop',
    'glt_tpu_torch.distributed.dist_sampling_producer',
    'glt_tpu_torch.distributed.dist_server',
    'glt_tpu_torch.distributed.dist_client',
    'glt_tpu_torch.distributed.channel_loader',
    'glt_tpu_torch.examples.feature_mp',
    'glt_tpu_torch.examples.distributed.server_client_mode')))
print('FRONTEND', all(m in sys.modules for m in (
    'glt_tpu_torch.obs', 'glt_tpu_torch.obs.registry',
    'glt_tpu_torch.obs.trace', 'glt_tpu_torch.obs.recorder',
    'glt_tpu_torch.utils.env', 'glt_tpu_torch.utils.profile',
    'glt_tpu_torch.utils.checkpoint', 'glt_tpu_torch.serving.metrics',
    'glt_tpu_torch.serving.batcher', 'glt_tpu_torch.serving.server',
    'glt_tpu_torch.serving.fleet',
    'glt_tpu_torch.examples.serve_sage_products')))
print('STREAM_REST', all(m in sys.modules for m in (
    'glt_tpu_torch.resilience.chaos',
    'glt_tpu_torch.examples.stream_updates')))
print('DATA_SOURCES', all(m in sys.modules for m in (
    'glt_tpu_torch.data.table_dataset', 'glt_tpu_torch.data.vineyard_utils',
    'glt_tpu_torch.distributed.dist_random_partitioner',
    'glt_tpu_torch.parallel.multihost', 'glt_tpu_torch.utils.tensor',
    'glt_tpu_torch.examples.pai_table_train',
    'glt_tpu_torch.examples.igbh.compress_graph')))
from glt_tpu_torch.channel import shm
lib = shm.get_lib()
maps = [ln.split(None, 5)[-1].strip() for ln in open('/proc/self/maps')
        if 'libglt_shm' in ln]
print('SHM_LIB', lib._name == shm.LIBRARY
      and shm.LIBRARY.endswith('glt_tpu_torch/_build/libglt_shm.so')
      and bool(maps) and all(m.startswith(shm.LIBRARY) for m in maps))
import torch
print('CUDA_INIT', torch.cuda.is_initialized())
'''


def test_port_and_chip_smoke_import_no_jax():
  env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
  out = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  assert 'BAD []' in out.stdout, out.stdout
  assert int(out.stdout.split('LOADED ')[1].split()[0]) >= 60
  assert 'HETERO True' in out.stdout, out.stdout
  assert 'STREAM True' in out.stdout, out.stdout
  assert 'TRAIN True' in out.stdout, out.stdout
  assert 'BENCH True' in out.stdout, out.stdout
  assert 'LINK True' in out.stdout, out.stdout
  assert 'TIER True' in out.stdout, out.stdout
  assert 'SUPERSTEP True' in out.stdout, out.stdout
  assert 'DIST True' in out.stdout, out.stdout
  assert 'HGT True' in out.stdout, out.stdout
  assert 'DIST_HOMO True' in out.stdout, out.stdout
  assert 'SERVER_CLIENT True' in out.stdout, out.stdout
  assert 'FRONTEND True' in out.stdout, out.stdout
  assert 'STREAM_REST True' in out.stdout, out.stdout
  assert 'DATA_SOURCES True' in out.stdout, out.stdout
  assert 'SHM_LIB True' in out.stdout, out.stdout
  assert 'CUDA_INIT False' in out.stdout, out.stdout
