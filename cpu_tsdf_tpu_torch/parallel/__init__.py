"""The sharded paths on ``torch.distributed``: dense slab sharding and the
ray-sharded render (``sharding``), slab-sharded brick integration
(``bricks``), the sharded ray-march renders (``raycast``) and the
multi-process runtime (``distributed``). Port of ``cpu_tsdf_tpu.parallel``;
every rank calls these functions in the same order."""

from .raycast import render_view_pallas_sharded  # noqa: F401
from .sharding import (  # noqa: F401
    integrate_sharded,
    make_tsdf_mesh,
    render_view_sharded,
    replicate_volume,
    shard_volume,
)
