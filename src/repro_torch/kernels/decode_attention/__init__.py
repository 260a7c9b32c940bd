from repro_torch.kernels.decode_attention.kernel import (
    decode_attention,
    paged_decode_attention,
    paged_mla_decode_attention,
)
from repro_torch.kernels.decode_attention.ops import (
    attend_decode,
    attend_decode_paged,
    attend_decode_paged_mla,
)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
    paged_mla_decode_attention_ref,
)
