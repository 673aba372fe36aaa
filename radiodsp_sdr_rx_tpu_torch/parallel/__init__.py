"""The sharded paths: mesh, channel sharding, time-axis halo exchange
(``radiodsp_sdr_rx_tpu/parallel``).

``mesh.py`` builds a (channel, time) grid of devices, in one process or over
a process group; ``collectives.py`` gives each kind of mesh its collectives;
``stream_shard.py`` runs the chains over it (time-sharded with halos and
exact seam fix-ups, channel-sharded, both); ``fused_shard.py`` channel-shards
the fused banks; ``halo.py`` is the ring halo kernel K9 (JAX's
``pallas_halo.py``), exported under the port's names.
"""

from radiodsp_sdr_rx_tpu_torch.parallel.fused_shard import ShardedFusedBank
from radiodsp_sdr_rx_tpu_torch.parallel.halo import ring_shift_right, shift_from_left_kernel
from radiodsp_sdr_rx_tpu_torch.parallel.mesh import (
    Mesh,
    initialize_distributed,
    make_global_mesh,
    make_mesh,
)
from radiodsp_sdr_rx_tpu_torch.parallel.stream_shard import (
    make_bank_time_sharded_chain,
    make_time_sharded_ssb_chain,
    shard_channel_bank,
    sharded_agc_envelope,
    sharded_first_order_iir,
    sharded_overlap_save,
    sharded_panadapter,
)

__all__ = ["Mesh", "ShardedFusedBank", "initialize_distributed", "make_bank_time_sharded_chain",
           "make_global_mesh", "make_mesh", "make_time_sharded_ssb_chain", "ring_shift_right",
           "shard_channel_bank", "sharded_agc_envelope", "sharded_first_order_iir",
           "sharded_overlap_save", "sharded_panadapter", "shift_from_left_kernel"]
