from repro_torch.kernels.ssd.kernel import ssd_chunked
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
