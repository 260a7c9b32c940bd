"""Serving: the generative engine, its numpy modules copied from the JAX
package (imports rewritten), and the port's decode runner."""
from repro_torch.serving.arrivals import maf_trace, video_trace
from repro_torch.serving.engine import EngineCore, GenerativeAdapter
from repro_torch.serving.generative import (
    GenerativeConfig,
    GenerativeEngine,
    offered_decode_qps,
)
from repro_torch.serving.metrics import (
    savings_vs,
    summarize,
    summarize_cluster,
    summarize_generative,
)
from repro_torch.serving.request import (
    GenRequest,
    GenResponse,
    Request,
    Response,
    make_gen_requests,
)
from repro_torch.serving.runner import DecodeRunner, PoolExhausted

__all__ = [
    "maf_trace",
    "video_trace",
    "EngineCore",
    "GenerativeAdapter",
    "GenerativeConfig",
    "GenerativeEngine",
    "offered_decode_qps",
    "savings_vs",
    "summarize",
    "summarize_cluster",
    "summarize_generative",
    "GenRequest",
    "GenResponse",
    "Request",
    "Response",
    "make_gen_requests",
    "DecodeRunner",
    "PoolExhausted",
]
