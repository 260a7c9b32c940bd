"""ctypes wrapper of the CUDA SSD chunk-scan kernel (``csrc/ssd_chunked.cu``).

``ssd_chunked`` replaces the JAX package's Pallas ``ssd_chunked``: Mamba2's
chunked state-space-duality scan, one CTA per (head, batch, 32-wide slice of
the head dim, ``ssd_slices``) carrying its (32, N) part of the state through
the chunks. It reads x, dt, B and C by stride, so the model's (B, H, S, hp)
and (B, H, S) views of its (B, S, H, hp) and (B, S, H) activations and its
(B, S, N) slices of the conv output cost no copy, and it writes y into
(B, S, H, hp) storage, returned as a (B, H, S, hp) view. Any S >= 1: the
kernel masks a ragged last chunk. Launches on PyTorch's current stream,
never syncs. ``ssd_chunked_meta`` runs the same checks on meta tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import KernelShapeError
from repro_torch.kernels.build import check_launch, load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = {"ssd_chunked_launch": [_P] * 7 + [_I] * 5 + [_L] * 13 + [_I, _P],
         "ssd_chunked_ctas_per_sm": [_I] * 2}
CHUNK = 64  # the kernel's chunk length
MAX_HP, MAX_N = 64, 128  # the kernel's thread layout
SSD_SLICE = 32  # head-dim columns a CTA
_fns = {}


def _fn(name="ssd_chunked_launch"):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load("ssd_chunked"), name)
        fn.argtypes = _ARGS[name]
        fn.restype = _I
        _fns[name] = fn
    return fn


def ssd_slices(hp: int) -> int:
    """Head-dim slices of the kernel's grid (H, B, slices): SSD_SLICE columns
    each, the last one what is left; a static shape only."""
    return -(-hp // SSD_SLICE)


def _refuse(what, x, dt, A, Bm, Cm, hp, N, on_card=True):
    """Raise the reason the operands are refused, if any (on the card, the
    slow path; ``on_card`` false: every operand on meta)."""
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if on_card and (t.device.type != "cuda" or t.device != x.device):
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {x.device}")
        if not on_card and t.device.type != "meta":
            raise ValueError(f"{what}: {name} must be a meta tensor, beside x")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise ValueError(f"{what}: {name} dtype {t.dtype} differs from x's {x.dtype}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what}: x dtype {x.dtype}; needs float32 or bfloat16")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last dim")
    if not (1 <= hp <= MAX_HP and 1 <= N <= MAX_N):
        raise KernelShapeError(f"{what}: needs hp <= {MAX_HP} and N <= {MAX_N}, "
                               f"got hp={hp} N={N}")


def _shapes(what, x, dt, A, Bm, Cm, chunk):
    """(B, H, S, hp, N) once the shapes agree and ``chunk`` is the kernel's."""
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 3 or Bm.shape != Cm.shape:
        raise ValueError(f"{what}: bad shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)}")
    B, H, S, hp = x.shape
    N = Bm.shape[2]
    if dt.shape != (B, H, S) or Bm.shape[:2] != (B, S) or A.shape != (H,):
        raise ValueError(f"{what}: bad shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} Bm {tuple(Bm.shape)}")
    if chunk != CHUNK:
        raise KernelShapeError(f"{what}: the kernel chunks by {CHUNK}, got chunk={chunk}")
    return B, H, S, hp, N


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, *, chunk: int = CHUNK):
    """x (B, H, S, hp); dt (B, H, S); A (H,) (negative); Bm, Cm (B, S, N),
    one group shared by every head. x, Bm and Cm share a dtype (float32 or
    bfloat16) and have a contiguous last dim; dt and A are taken as float32.
    hp <= 64, N <= 128; ``chunk`` must be the kernel's 64. Returns
    (y (B, H, S, hp) f32, final_state (B, H, hp, N) f32)."""
    what = "ssd_chunked"
    B, H, S, hp, N = _shapes(what, x, dt, A, Bm, Cm, chunk)
    dev, xt = x.get_device(), x.dtype
    if (dev < 0 or dt.get_device() != dev or A.get_device() != dev or Bm.get_device() != dev
            or Cm.get_device() != dev or Bm.dtype != xt or Cm.dtype != xt or xt not in _DTYPES
            or x.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1
            or not (1 <= hp <= MAX_HP and 1 <= N <= MAX_N)):
        _refuse(what, x, dt, A, Bm, Cm, hp, N)
    if S < 1:
        raise ValueError(f"{what}: needs S >= 1 steps")
    if dt.dtype != torch.float32:
        dt = dt.float()
    if A.dtype != torch.float32 or A.stride(0) != 1:
        A = A.float().contiguous()
    y = x.new_empty((B, S, H, hp), dtype=torch.float32).transpose(1, 2)
    state = x.new_empty((B, H, hp, N), dtype=torch.float32)
    if B == 0 or H == 0:
        return y, state
    xs, ds, ys = x.stride(), dt.stride(), y.stride()
    rc = _fn()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
               y.data_ptr(), state.data_ptr(), B, H, S, hp, N, xs[0], xs[1], xs[2], ds[0],
               ds[1], ds[2], Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1), ys[0],
               ys[1], ys[2], _DTYPES[xt], torch._C._cuda_getCurrentRawStream(dev))
    check_launch(rc, what)
    ssd_chunked.launches += 1
    return y, state


ssd_chunked.launches = 0


def ssd_chunked_meta(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                     Cm: torch.Tensor, *, chunk: int = CHUNK):
    """``ssd_chunked``'s contract on meta tensors: its checks, its outputs (y
    (B, H, S, hp) f32 as a view of (B, S, H, hp) storage, final_state (B, H,
    hp, N) f32), no launch."""
    what = "ssd_chunked"
    B, H, S, hp, N = _shapes(what, x, dt, A, Bm, Cm, chunk)
    _refuse(what, x, dt, A, Bm, Cm, hp, N, on_card=False)
    if S < 1:
        raise ValueError(f"{what}: needs S >= 1 steps")
    if B > 65535:
        raise KernelShapeError(f"{what}: needs B <= 65535, got B={B}")
    y = x.new_empty((B, S, H, hp), dtype=torch.float32).transpose(1, 2)
    return y, x.new_empty((B, H, hp, N), dtype=torch.float32)


def ssd_launch_info(dtype, B, H, hp, N=MAX_N):
    """The slice count and the CTAs an SM (as the card's occupancy API
    reports them) of an SSD launch: what chip_smoke.py prints beside the
    kernel rows."""
    n = _fn("ssd_chunked_ctas_per_sm")(_DTYPES[dtype], N)
    if n < 0:
        check_launch(-n, "ssd_chunked_ctas_per_sm")
    slices = ssd_slices(hp)
    return {"slices": slices, "ctas": B * H * slices, "ctas_per_sm": n}
