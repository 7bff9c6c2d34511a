"""Multi-chip execution over a jax.sharding.Mesh.

The reference is single-GPU (SURVEY.md §2.6 — no distributed anything); this
package is the extension axis: row-sharded sparse operators over a device
mesh with XLA collectives inserted by GSPMD (NCCL on GPUs), plus
explicitly-psummed solver reductions.
"""

from cusp_autotuned_tpu.parallel.sharded import (
    make_row_mesh, shard_rows, shard_rows_aligned, replicate,
    distributed_cg, distributed_bicgstab, sharded_spmv,
    distribute_for_solve, distribute_multilevel,
)
from cusp_autotuned_tpu.parallel.shard_map_spmv import (
    sharded_spmv_dia_shardmap, distributed_cg_shardmap, distributed_cg_halo,
)
