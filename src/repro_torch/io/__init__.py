"""Sharded projection/volume I/O (port of `repro/io`): the shard-level
array store, the pipeline's ProjectionSource/VolumeSink endpoints, and the
StoreError corruption signal."""
from .shard_store import (  # noqa: F401
    HostShardedArray, StoreError, load_array, open_count, read_manifest,
    read_region, reset_open_count, save_array, snapshot, stored_spec,
)
from .streams import (  # noqa: F401
    AsyncWriteback, PrefetchError, ProjectionSource, SourcePrefetcher,
    VolumeSink,
)
