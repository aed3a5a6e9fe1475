"""Multi-process runtime (``torch.distributed``): :mod:`rald_torch.parallel.dist`."""
from rald_torch.parallel.dist import (
    all_reduce_mean_,
    all_reduce_sum,
    backend,
    barrier,
    destroy,
    draw_rows,
    init_distributed,
    is_main_process,
    local_device,
    process_info,
    rendezvous,
    world_rank,
)

__all__ = [
    "all_reduce_mean_",
    "all_reduce_sum",
    "backend",
    "barrier",
    "destroy",
    "draw_rows",
    "init_distributed",
    "is_main_process",
    "local_device",
    "process_info",
    "rendezvous",
    "world_rank",
]
