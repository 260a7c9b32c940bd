"""Dispatcher for the SSD chunk scan: the plain version for CPU tensors, the
CUDA kernel for CUDA tensors (it raises rather than fall back), the kernel's
contract for meta tensors (its checks, empty outputs)."""
from __future__ import annotations

from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.ssd.kernel import CHUNK, ssd_chunked, ssd_chunked_meta
from repro_torch.kernels.ssd.ref import ssd_chunked_ref


def ssd(x, dt, A, Bm, Cm, *, chunk=CHUNK, use_kernel=True):
    """x (B,H,S,hp), dt (B,H,S), A (H,), Bm/Cm (B,S,N) (one group). Returns
    (y (B,H,S,hp) f32, final_state (B,H,hp,N) f32).

    The plain version chunks as the reference's ``mamba_apply`` does: by
    ``chunk`` when it divides S, else one chunk of S. The kernel always
    chunks by its 64 and masks a ragged last chunk (zero steps leave the
    state unchanged); chunking changes the sums' order, not the function."""
    refuse_autograd("ssd", x, dt, A, Bm, Cm)
    if not use_kernel or x.device.type == "cpu":
        S = x.shape[2]
        return ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk if S % chunk == 0 else S)
    if x.device.type == "meta":
        return ssd_chunked_meta(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    return ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
