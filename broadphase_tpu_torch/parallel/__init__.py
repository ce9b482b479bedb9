"""The sharded broadphase over a ``torch.distributed`` process group.

PyTorch counterpart of ``broadphase_tpu/parallel/``, with the same module
split and public names; a process group (``group``, default the world)
takes the place of the mesh and its axis.  Each rank is one process with
its object shard and its fragment of the sorted tree:

* the one-shot build + scan step: :mod:`.scan`;
* the persistent :class:`ShardedLayer`: scan, merge, batched queries and
  the checkpoint bridge (:func:`gather_layer` / :func:`shard_layer`):
  :mod:`.layer`;
* the temporal-coherence update routed to key owners: :mod:`.update`;
* :func:`~.launch.run_ranks` starts the ranks of a group on one host.
"""

from .scan import (  # noqa: F401
    ShardedScanResult,
    gather_pairs,
    make_sharded_step,
    min_depth_for_devices,
    object_shard,
    sharded_scan_step,
)
from .layer import (  # noqa: F401
    ShardedLayer,
    gather_layer,
    make_build_sharded,
    make_merge_sharded,
    make_queries_sharded,
    make_scan_sharded,
    shard_layer,
)
from .update import (  # noqa: F401
    ShardedTracked,
    make_build_tracked_sharded,
    make_update_sharded,
)
from .launch import run_ranks  # noqa: F401
