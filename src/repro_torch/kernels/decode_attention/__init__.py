from repro_torch.kernels.decode_attention.kernel import decode_attention, paged_decode_attention
from repro_torch.kernels.decode_attention.ops import attend_decode, attend_decode_paged
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
)
