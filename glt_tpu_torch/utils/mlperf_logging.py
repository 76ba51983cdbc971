"""MLPerf-style structured logging (counterpart of
glt_tpu/utils/mlperf_logging.py, its own copy: the port imports nothing
of the JAX package). A dependency-free shim emitting the ``:::MLLOG``
line format, the same keys and values as the JAX package's, so the two
logs parse alike.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

INTERVAL_START = 'INTERVAL_START'
INTERVAL_END = 'INTERVAL_END'
POINT_IN_TIME = 'POINT_IN_TIME'


class MLLogger:
  def __init__(self, benchmark: str = 'gnn', org: str = 'glt_tpu',
               emit=print):
    self.benchmark = benchmark
    self.org = org
    self._emit = emit

  def _log(self, event_type: str, key: str, value: Any = None,
           metadata: Optional[Dict] = None) -> None:
    record = {
        'namespace': self.benchmark,
        'time_ms': int(time.time() * 1000),
        'event_type': event_type,
        'key': key,
        'value': value,
        'metadata': metadata or {},
    }
    self._emit(f':::MLLOG {json.dumps(record)}')

  def start(self, key: str, value: Any = None, metadata=None):
    self._log(INTERVAL_START, key, value, metadata)

  def end(self, key: str, value: Any = None, metadata=None):
    self._log(INTERVAL_END, key, value, metadata)

  def event(self, key: str, value: Any = None, metadata=None):
    self._log(POINT_IN_TIME, key, value, metadata)

  # convenience markers used by the IGBH-style loop
  def run_start(self):
    self.start('run_start')

  def run_stop(self, status: str = 'success', epoch: int = None):
    md = {'status': status}
    if epoch is not None:
      md['epoch_num'] = epoch
    self.end('run_stop', metadata=md)

  def epoch_start(self, epoch: int):
    self.start('epoch_start', metadata={'epoch_num': epoch})

  def epoch_stop(self, epoch: int):
    self.end('epoch_stop', metadata={'epoch_num': epoch})

  def eval_start(self, epoch: int):
    self.start('eval_start', metadata={'epoch_num': epoch})

  def eval_stop(self, epoch: int):
    self.end('eval_stop', metadata={'epoch_num': epoch})

  def eval_accuracy(self, value: float, epoch: int):
    self.event('eval_accuracy', value, metadata={'epoch_num': epoch})

  # submission/init block — the reference emits these via the official
  # mlperf_logging constants (examples/igbh/mlperf_logging_utils.py:12-33,
  # dist_train_rgnn.py:345-346,435-440); same key strings here so result
  # parsers treat the two logs identically.
  def submission_info(self, benchmark: str = 'GNN',
                      submitter: str = 'glt_tpu',
                      platform: str = 'tpu'):
    self.event('submission_benchmark', benchmark)
    self.event('submission_org', submitter)
    self.event('submission_division', 'closed')
    self.event('submission_status', 'onprem')
    self.event('submission_platform', platform)

  def init_start(self):
    self.event('cache_clear', True)
    self.start('init_start')

  def init_stop(self):
    self.end('init_stop')
