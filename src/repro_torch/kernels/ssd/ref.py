"""Plain version: the model substrate's chunked SSD reference, in the
kernel's layout (mirrors the JAX package's ``kernels/ssd/ref.py``)."""
from __future__ import annotations

from repro_torch.models.mamba import ssd_ref


def ssd_chunked_ref(x, dt, A, Bm, Cm, *, chunk=64):
    """Same layout as the kernel: x (B,H,S,hp), dt (B,H,S), Bm/Cm (B,S,N).
    Returns (y (B,H,S,hp) f32, final_state (B,H,hp,N) f32)."""
    xs = x.transpose(1, 2)  # (B,S,H,hp)
    dts = dt.transpose(1, 2)  # (B,S,H)
    y, st = ssd_ref(xs, dts, A, Bm[:, :, None], Cm[:, :, None], chunk=chunk)
    return y.transpose(1, 2), st
