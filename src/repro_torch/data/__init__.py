from repro_torch.data.synthetic import (
    Stream,
    TokenPipeline,
    make_decode_stream,
    make_image_stream,
    make_token_stream,
)

__all__ = [
    "Stream",
    "TokenPipeline",
    "make_decode_stream",
    "make_image_stream",
    "make_token_stream",
]
