"""Multi-rank serving and training over ``torch.distributed``: the
collectives of tensor-parallel decode, expert parallelism, the FSDP
gather and reduce-scatter, the pipeline ring and the gradient all-reduces
(``collectives``), the exit-gated pipeline decode window and the GPipe
forward (``pipeline``)."""
from repro_torch.distributed.collectives import (
    KeepModel,
    SumModel,
    all_gather_ad,
    all_gather_tiled,
    all_reduce_flat,
    all_to_all_ad,
    all_to_all_tiled,
    compressed_psum,
    count_collectives,
    dequantize_int8,
    fsdp_gather_ad,
    fsdp_gather_tree,
    from_model_region,
    make_compressed_grad_allreduce,
    max_over,
    quantize_int8,
    reduce_scatter_tiled,
    ring_shift,
    sum_over,
    take_chunk_ad,
    to_model_region,
    tp_gather,
)
from repro_torch.distributed.pipeline import pipeline_apply, pipeline_check, pipeline_decode_window

__all__ = ["KeepModel", "SumModel", "all_gather_ad", "all_gather_tiled", "all_reduce_flat",
           "all_to_all_ad", "all_to_all_tiled", "compressed_psum", "count_collectives",
           "dequantize_int8", "fsdp_gather_ad", "fsdp_gather_tree", "from_model_region",
           "make_compressed_grad_allreduce", "max_over", "pipeline_apply", "pipeline_check",
           "pipeline_decode_window", "quantize_int8", "reduce_scatter_tiled", "ring_shift",
           "sum_over", "take_chunk_ad", "to_model_region", "tp_gather"]
