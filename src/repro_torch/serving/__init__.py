"""Serving: the engine and its numpy modules copied from the JAX package
(imports rewritten), and the port's model runners."""
from repro_torch.serving.arrivals import maf_trace, video_trace
from repro_torch.serving.cluster import (
    ClusterConfig,
    ClusterSimulator,
    MixedClusterSimulator,
    Worker,
    get_dispatcher,
    release_offset,
)
from repro_torch.serving.engine import ClassificationAdapter, EngineCore, GenerativeAdapter
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
from repro_torch.serving.platform import PlatformConfig, ServingSimulator, make_requests
from repro_torch.serving.policies import (
    AdmissionConfig,
    AdmissionPolicy,
    BatchPolicy,
    get_policy,
)
from repro_torch.serving.request import (
    GenRequest,
    GenResponse,
    Request,
    Response,
    make_gen_requests,
)
from repro_torch.serving.runner import (
    ClassifierRunner,
    DecodeRunner,
    LMTokenRunner,
    PoolExhausted,
    SyntheticRunner,
)

__all__ = [
    "maf_trace",
    "video_trace",
    "ClusterConfig",
    "ClusterSimulator",
    "MixedClusterSimulator",
    "Worker",
    "get_dispatcher",
    "release_offset",
    "ClassificationAdapter",
    "EngineCore",
    "GenerativeAdapter",
    "GenerativeConfig",
    "GenerativeEngine",
    "offered_decode_qps",
    "savings_vs",
    "summarize",
    "summarize_cluster",
    "summarize_generative",
    "PlatformConfig",
    "ServingSimulator",
    "make_requests",
    "AdmissionConfig",
    "AdmissionPolicy",
    "BatchPolicy",
    "get_policy",
    "GenRequest",
    "GenResponse",
    "Request",
    "Response",
    "make_gen_requests",
    "ClassifierRunner",
    "DecodeRunner",
    "LMTokenRunner",
    "PoolExhausted",
    "SyntheticRunner",
]
