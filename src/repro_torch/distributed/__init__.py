"""Multi-rank serving over ``torch.distributed``: the collectives of
tensor-parallel decode, expert parallelism and the pipeline ring
(``collectives``), and the exit-gated pipeline decode window
(``pipeline``)."""
from repro_torch.distributed.collectives import (
    all_gather_tiled,
    all_to_all_tiled,
    ring_shift,
    sum_over,
    tp_gather,
)
from repro_torch.distributed.pipeline import pipeline_check, pipeline_decode_window

__all__ = ["all_gather_tiled", "all_to_all_tiled", "pipeline_check", "pipeline_decode_window",
           "ring_shift", "sum_over", "tp_gather"]
