"""ctypes wrappers of the CUDA ramp-head kernel (``csrc/ramp_head.cu``).

Replace the JAX package's Pallas ``ramp_head_stats`` and ``ramp_head_exit``.
``w`` is a (d, V) view in either layout, contiguous along V (a ramp head
``head[site]``) or along d (the tied head ``embed.T``), read by stride with
no copy. A ragged last vocab tile is handled in the kernel. The scratch for
the partial records is sized by the library (``ramp_head_parts``: one per
256-column tile for float32, one per CTA of the bfloat16 kernel's single
wave). Launches on PyTorch's current stream, never syncs. The ``*_meta``
twins run the same checks on meta tensors, the launch plan's
shared-memory fit reckoned in Python (``smem_fits``).
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


def _lib():
    lib = load("ramp_head")
    if lib.ramp_head_launch.argtypes is None:
        lib.ramp_head_launch.argtypes = ([_P, _L, _P, _L, _L, _P, _L] + [_P] * 7
                                         + [_I] * 5 + [_P])
        lib.ramp_head_launch.restype = _I
        lib.ramp_head_parts.argtypes = [_I, _I, _I, _I, _L, _L, _I]
        lib.ramp_head_parts.restype = _I
    return lib


# the C source's launch shapes (csrc/ramp_head.cu), for the shared-memory
# fit the meta contract reckons without the library
_MAX_SMEM = 232448  # bytes of shared memory a block can use
_TV, _RB, _NW = 256, 8, 8  # float32: columns and rows of h a CTA, warps
_MBW, _NS, _NS_WIDE, _RNW, _MAXG = 16, 3, 2, 8, 4  # bfloat16: see plan_bf16
_STAT = 16  # bytes of a partial record (m, s, t, argmax)


def smem_fits(B: int, d: int, vmaj: bool, dtype) -> bool:
    """Whether a launch shape of the kernel fits h's rows of width ``d`` in
    shared memory: the float32 pass's fixed layout, or the bfloat16
    ``plan_bf16`` (the most row groups beside a ring of three stages, else
    one group beside two)."""
    if dtype == torch.float32:
        if vmaj:
            smem = (max(_RB * d, _NW * _RB * _TV) + _RB * _TV) * 4
        else:  # DStage<float>: 32 contraction elements a stage, rows of 36
            hsd = -(-d // 32) * 32
            smem = (_RB * hsd + _RB * _TV) * 4 + _TV * 36 * 4
        return smem <= _MAX_SMEM
    vc = 64 if vmaj else 32  # Tile<VMAJ>
    kc = 2048 // vc
    stage = (kc if vmaj else vc) * ((vc if vmaj else kc) + 8) * 2
    hsd = -(-d // kc) * kc

    def need(n, ns):
        return n * 8 * (hsd + 8) * 2 + _RNW * ns * stage + _RNW * n * 8 * _STAT

    ng = max(1, min(-(-B // 8), _MAXG))
    while ng > 1 and need(ng, _NS) > _MAX_SMEM:
        ng -= 1
    return min(need(ng, _NS), need(ng, _NS_WIDE)) <= _MAX_SMEM


def _check(h, w, what, on_card=True):
    """Raise the reason h and w are refused, if any: shapes, not on one card
    (or, ``on_card`` false, not both on meta), dtypes, h's strided rows,
    w's layout and row alignment, a float32 width past shared memory.
    Returns (B, d, V, w's strides)."""
    B, d = h.shape
    if w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f"{what}: bad shapes h {tuple(h.shape)} w {tuple(w.shape)}")
    V = w.shape[1]
    for name, t in (("h", h), ("w", w)):
        if on_card and (t.device.type != "cuda" or t.device != h.device):
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {h.device}")
        if not on_card and t.device.type != "meta":
            raise ValueError(f"{what}: {name} must be a meta tensor, beside h")
        if t.dtype != h.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{what}: {name} dtype {t.dtype}; needs float32/bfloat16, "
                             "alike for h and w")
    if h.stride(1) != 1:
        raise ValueError(f"{what}: h needs a contiguous last dim")
    sk, sv = w.stride()
    if 1 not in (sk, sv):
        raise ValueError(f"{what}: w must be contiguous along d or V, strides {w.stride()}")
    if w.data_ptr() % 16 or ((sk if sv == 1 else sv) * w.element_size()) % 16:
        raise ValueError(f"{what}: w rows must be 16-byte aligned (strides {w.stride()})")
    # the float32 pass's layout is fixed; the bfloat16 plan is the library's
    if h.dtype == torch.float32 and B and not smem_fits(B, d, sv == 1, h.dtype):
        raise KernelShapeError(f"{what}: no launch shape fits d={d} in shared memory")
    return B, d, V, sk, sv


def _launch(h, w, thresholds, v_limit, what):
    B, d, V, sk, sv = _check(h, w, what)
    dev = h.device
    v_limit = V if v_limit is None else int(v_limit)
    m = torch.empty(B, dtype=torch.float32, device=dev)
    s, t = torch.empty_like(m), torch.empty_like(m)
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    ex = None
    thr_ptr, thr_stride = None, 0
    if thresholds is not None:
        thr = thresholds.to(device=dev, dtype=torch.float32)
        if thr.shape != (B,):
            raise ValueError(f"{what}: thresholds shape {tuple(thr.shape)}, needs ({B},)")
        thr_ptr, thr_stride = thr.data_ptr(), thr.stride(0)
        ex = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return m, s, t, idx, ex
    lib = _lib()
    n_parts = lib.ramp_head_parts(B, d, V, v_limit, sk, sv, _DTYPES[h.dtype])
    if n_parts < 1:
        raise KernelShapeError(f"{what}: no launch shape fits d={d} in shared memory")
    part_f = torch.empty(3 * B * n_parts, dtype=torch.float32, device=dev)
    part_i = torch.empty(B * n_parts, dtype=torch.int32, device=dev)
    rc = lib.ramp_head_launch(
        h.data_ptr(), h.stride(0), w.data_ptr(), sk, sv, thr_ptr, thr_stride,
        part_f.data_ptr(), part_i.data_ptr(), m.data_ptr(), s.data_ptr(), t.data_ptr(),
        idx.data_ptr(), None if ex is None else ex.data_ptr(), B, d, V, v_limit,
        _DTYPES[h.dtype], torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, what)
    # counted here, where the kernel launched: B == 0 returned above uncounted
    (ramp_head_stats if ex is None else ramp_head_exit).launches += 1
    return m, s, t, idx, ex


def ramp_head_stats(h: torch.Tensor, w: torch.Tensor, *, v_limit=None):
    """h (B, d); w (d, V). Returns (m, s, t, argmax): m = max logit,
    s = sum e^{l-m}, t = sum l*e^{l-m} (f32), argmax int32 (B,).
    Columns >= v_limit (padded vocab) are masked to -1e30."""
    m, s, t, idx, _ = _launch(h, w, None, v_limit, "ramp_head_stats")
    return m, s, t, idx


def ramp_head_exit(h: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor, *,
                   v_limit=None):
    """The stats plus ``exit`` int32 (B,): 1 where ``(1 - 1/s) < threshold``
    (strict, in f32). ``thresholds`` is (B,) and may be a stride-0 view."""
    return _launch(h, w, thresholds, v_limit, "ramp_head_exit")


ramp_head_stats.launches = 0
ramp_head_exit.launches = 0


def _meta(h, w, thresholds, what):
    """The contract of either kernel on meta tensors: its checks and the
    launch plan's shared-memory fit; its (B,) outputs, no launch."""
    B, d, _, _, sv = _check(h, w, what, on_card=False)
    m = torch.empty(B, dtype=torch.float32, device="meta")
    idx = torch.empty(B, dtype=torch.int32, device="meta")
    ex = None
    if thresholds is not None:
        if thresholds.device.type != "meta":
            raise ValueError(f"{what}: thresholds must be a meta tensor, beside h")
        if thresholds.shape != (B,):
            raise ValueError(f"{what}: thresholds shape {tuple(thresholds.shape)}, "
                             f"needs ({B},)")
        ex = torch.empty(B, dtype=torch.int32, device="meta")
    if B and h.dtype == torch.bfloat16 and not smem_fits(B, d, sv == 1, h.dtype):
        raise KernelShapeError(f"{what}: no launch shape fits d={d} in shared memory")
    return m, torch.empty_like(m), torch.empty_like(m), idx, ex


def ramp_head_stats_meta(h: torch.Tensor, w: torch.Tensor, *, v_limit=None):
    """``ramp_head_stats``' contract on meta tensors: (m, s, t, argmax)."""
    return _meta(h, w, None, "ramp_head_stats")[:4]


def ramp_head_exit_meta(h: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor, *,
                        v_limit=None):
    """``ramp_head_exit``'s contract on meta tensors: (m, s, t, argmax, exit)."""
    return _meta(h, w, thresholds, "ramp_head_exit")
