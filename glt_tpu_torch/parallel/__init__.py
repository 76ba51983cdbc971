from .collectives import (BucketMeta, all_to_all, bucket_by_owner,
                          bucket_payload, capped_drain, drain_rounds,
                          sharded_segment_mean,
                          sharded_segment_mean_scattered, unbucket)
from .dist_feature import (ShardedFeature, overflow_lanes,
                           require_device_resident)
from .mesh import Mesh, make_mesh, replicated, row_sharded
from .train import SPMDSageTrainStep, SageTrainStep, link_bce_loss, sage_loss

__all__ = ['BucketMeta', 'Mesh', 'SPMDSageTrainStep', 'SageTrainStep',
           'ShardedFeature', 'all_to_all', 'bucket_by_owner',
           'bucket_payload', 'capped_drain', 'drain_rounds',
           'link_bce_loss', 'make_mesh', 'overflow_lanes', 'replicated',
           'require_device_resident', 'row_sharded', 'sage_loss',
           'sharded_segment_mean', 'sharded_segment_mean_scattered',
           'unbucket']
