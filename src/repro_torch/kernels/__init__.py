"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, and the glue that feeds them (``ops``).

scan_agg_locate      — fused locate+scan (csrc/scan_locate.cu)
select_compact       — select row-index compaction (csrc/select_compact.cu)
merge_run_positions  — merge ranks of a resident run stack (csrc/merge_rank.cu)
ecdf_hist            — histogram for the ECDF refresh (csrc/ecdf_hist.cu)
block_sums           — per-block partial sums for views (csrc/block_sums.cu)
boundary_block_sums  — boundary-block rescans for views (csrc/block_sums.cu)
slab_locate          — slab location by binary search (csrc/slab_rank.cu)
scan_agg_rowstream   — row-slab scan, rows outer (csrc/scan_agg.cu)
scan_agg_qgrid       — row-slab scan, queries outer (csrc/scan_agg.cu)

A wrapper runs its kernel on CUDA tensors and its plain version on CPU
tensors, and counts its kernel launches in ``<wrapper>.launches``.
"""

from .block_agg import (
    block_sums,
    block_sums_plain,
    boundary_block_sums,
    boundary_block_sums_plain,
)
from .ecdf_hist import ecdf_hist, ecdf_hist_plain
from .merge_runs import merge_run_positions, merge_run_positions_plain
from .ops import (
    DEVICE_BLOCK_N,
    build_device_state,
    device_key_plan,
    device_state_append,
    merge_device_runs,
    scan_agg,
    scan_agg_batched,
    state_from_numpy,
    table_execute_device_many,
    table_scan_device,
    table_scan_device_many,
    table_slab_locate_many,
)
from .scan_agg import (
    scan_agg_qgrid,
    scan_agg_qgrid_plain,
    scan_agg_rowstream,
    scan_agg_rowstream_plain,
)
from .slab_locate import (
    scan_agg_locate,
    scan_agg_locate_plain,
    select_compact,
    select_compact_plain,
    slab_locate,
    slab_locate_plain,
)

#: Every kernel wrapper of the port, by the name reports use.
KERNELS = {
    "scan_agg_locate": scan_agg_locate,
    "select_compact": select_compact,
    "merge_run_positions": merge_run_positions,
    "ecdf_hist": ecdf_hist,
    "block_sums": block_sums,
    "boundary_block_sums": boundary_block_sums,
    "slab_locate": slab_locate,
    "scan_agg_rowstream": scan_agg_rowstream,
    "scan_agg_qgrid": scan_agg_qgrid,
}

__all__ = [
    "DEVICE_BLOCK_N",
    "KERNELS",
    "block_sums",
    "block_sums_plain",
    "boundary_block_sums",
    "boundary_block_sums_plain",
    "build_device_state",
    "device_key_plan",
    "device_state_append",
    "ecdf_hist",
    "ecdf_hist_plain",
    "merge_device_runs",
    "merge_run_positions",
    "merge_run_positions_plain",
    "scan_agg",
    "scan_agg_batched",
    "scan_agg_locate",
    "scan_agg_locate_plain",
    "scan_agg_qgrid",
    "scan_agg_qgrid_plain",
    "scan_agg_rowstream",
    "scan_agg_rowstream_plain",
    "select_compact",
    "select_compact_plain",
    "slab_locate",
    "slab_locate_plain",
    "state_from_numpy",
    "table_execute_device_many",
    "table_scan_device",
    "table_scan_device_many",
    "table_slab_locate_many",
]
