"""Live graph and feature updates: delta buffers, versioned snapshots,
cache-coherent serving (counterpart of glt_tpu/stream).

The write path is::

  writers --> EdgeDeltaBuffer / FeatureDeltaBuffer   (stage)
                  |-- SnapshotManager.build_overlay  (refresh: device CSR
                  |                                   overlays)
                  `-- StreamIngestor ----------------(compact: merge into
                         |                            a fresh CSR, RCU swap)
                         |-- StreamSampler.refresh_overlay / snapshot swap
                         `-- InferenceEngine.update_snapshot
                                `-- EmbeddingCache.invalidate(touched)

and the read path samples the current snapshot plus one fixed-width
overlay window per hop. ``StreamIngestor.start`` runs the refresh and the
policy's compaction on a background thread; a CSR base serves 'out'
sampling, a CSC base 'in' sampling.
"""
from .delta import (DeltaOverflow, EdgeDeltaBuffer, EdgeDeltaCut,
                    FeatureDeltaBuffer, FeatureDeltaCut)
from .ingest import CompactionPolicy, StreamIngestor
from .sampler import StreamSampler
from .snapshot import Snapshot, SnapshotManager

__all__ = [
    'DeltaOverflow', 'EdgeDeltaBuffer', 'EdgeDeltaCut',
    'FeatureDeltaBuffer', 'FeatureDeltaCut',
    'CompactionPolicy', 'StreamIngestor',
    'StreamSampler', 'Snapshot', 'SnapshotManager',
]
