"""Channels of SampleMessages between processes (counterpart of
glt_tpu/channel): the wire format, the shared-memory ring and its channel,
the ``multiprocessing`` fallback, and the prefetching receiver of the
server-client mode. Host code: nothing here touches a card."""
from .base import ChannelBase, SampleMessage, pack_message, unpack_message
from .mp_channel import MpChannel
from .remote_channel import RemoteReceivingChannel
from .shm import QueueTimeoutError, ShmQueue
from .shm_channel import ShmChannel

__all__ = [
    'ChannelBase', 'SampleMessage', 'pack_message', 'unpack_message',
    'ShmQueue', 'QueueTimeoutError',
    'ShmChannel', 'MpChannel', 'RemoteReceivingChannel',
]
