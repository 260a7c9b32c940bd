"""Mamba2 (SSD, state-space duality) block [arXiv:2405.21060].

The port's counterpart of the JAX package's ``models/mamba.py``. Layout
follows the published block: in_proj -> [z | x | B | C | dt], causal
depthwise conv over [x|B|C], SSD scan, gated RMSNorm, out_proj.

``ssd_ref`` is the chunked reference (plain PyTorch, f32 internals; also the
plain version of the SSD kernel in ``kernels/ssd``). ``ssd_decode_step`` is
the O(1) recurrent step used for serving. The conv, the recurrent step, the
gated norm and the projections stay plain PyTorch, as the JAX package keeps
them outside any Pallas kernel; a prefill's chunk scan goes through
``kernels.ssd.ops.ssd`` (the CUDA kernel on CUDA tensors).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamInfo, torch_dtype
from repro_torch.models.layers import rms_norm


def _dims(cfg):
    di, N, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_headdim
    H, G = di // hp, cfg.ssm_ngroups
    return di, N, hp, H, G, di + 2 * G * N


def mamba_schema(cfg, L=None) -> dict:
    d = cfg.d_model
    di, N, hp, H, G, conv_dim = _dims(cfg)
    dt = torch_dtype(cfg.dtype)
    pre = () if L is None else (L,)
    pfx = (None,) * len(pre)
    d_in_proj = 2 * di + 2 * G * N + H
    sc = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "in_proj": ParamInfo(pre + (d, d_in_proj), dt, "normal:0.02", (*pfx, "data", "model")),
        "conv_w": ParamInfo(pre + (cfg.d_conv, conv_dim), dt, "normal:0.2", (*pfx, None, "model")),
        "conv_b": ParamInfo(pre + (conv_dim,), dt, "zeros", (*pfx, "model")),
        "A_log": ParamInfo(pre + (H,), torch.float32, "ssm_a", pfx),
        "D": ParamInfo(pre + (H,), torch.float32, "ones", pfx),
        "dt_bias": ParamInfo(pre + (H,), torch.float32, "dt_bias", pfx),
        "norm_w": ParamInfo(pre + (di,), torch.float32, "zeros", pfx),
        "out_proj": ParamInfo(pre + (di, d), dt, f"normal:{sc}", (*pfx, "model", "data")),
    }


def segsum(a):
    """Stable segment-sum: out[..., i, j] = sum a[..., j+1:i+1], -inf for j>i.
    a: (..., T) -> (..., T, T)."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)  # x[..., i, j] = a_i
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device), -1)
    x = torch.where(mask, x, 0.0)
    x = torch.cumsum(x, dim=-2)  # out[i,j] = sum_{j<i'<=i} a_i'
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device), 0)
    return torch.where(mask, x, -math.inf)


def ssd_ref(x, dt, A, B, C, chunk: int = 64, init_state=None):
    """Chunked SSD (Mamba2 Algorithm; fp32 internals).

    x: (b, s, h, p); dt: (b, s, h) (post-softplus); A: (h,) (negative);
    B, C: (b, s, g, n). Returns (y (b,s,h,p), final_state (b,h,p,n))."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    x, dt = x.float(), dt.float()
    B = torch.repeat_interleave(B.float(), rep, dim=2)  # (b,s,h,n)
    C = torch.repeat_interleave(C.float(), rep, dim=2)
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, h, n)
    Cc = C.reshape(b, nc, chunk, h, n)
    a = dtc * A  # (b,nc,l,h)
    a = a.movedim(-1, -2)  # (b,nc,h,l)
    a_cum = torch.cumsum(a, dim=-1)
    xdt = xc * dtc[..., None]
    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(segsum(a))  # (b,nc,h,l,l)
    Ydiag = torch.einsum("bclhn,bcshn,bchls,bcshp->bclhp", Cc, Bc, L, xdt)
    # 2. chunk states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (b,nc,h,l)
    states = torch.einsum("bclhn,bchl,bclhp->bchpn", Bc, decay_states, xdt)
    # 3. inter-chunk recurrence: the state *entering* each chunk
    if init_state is None:
        init_state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    chunk_decay = torch.exp(a_cum[..., -1])  # (b,nc,h)
    carry, entering = init_state.float(), []
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)  # (b,nc,h,p,n)
    # 4. state -> output contribution
    state_decay = torch.exp(a_cum)  # (b,nc,h,l)
    Yoff = torch.einsum("bclhn,bchpn,bchl->bclhp", Cc, entering, state_decay)
    y = (Ydiag + Yoff).reshape(b, s, h, p)
    return y, carry


def ssd_decode_step(state, x, dt, A, B, C):
    """One recurrent step. state: (b,h,p,n); x: (b,h,p); dt: (b,h);
    A: (h,); B,C: (b,g,n). Returns (y (b,h,p), new_state)."""
    h = x.shape[1]
    rep = h // B.shape[1]
    x, dt = x.float(), dt.float()
    B = torch.repeat_interleave(B.float(), rep, dim=1)  # (b,h,n)
    C = torch.repeat_interleave(C.float(), rep, dim=1)
    dA = torch.exp(dt * A)  # (b,h)
    new_state = state * dA[..., None, None] + torch.einsum(
        "bhn,bhp->bhpn", B, x * dt[..., None])
    y = torch.einsum("bhpn,bhn->bhp", new_state, C)
    return y, new_state


def _conv_step(conv_state, xbc, w, b):
    """Depthwise causal conv, single step. conv_state: (B, d_conv-1, D);
    xbc: (B, D). Returns (out (B,D), new_state)."""
    window = torch.cat([conv_state, xbc[:, None]], dim=1)  # (B,d_conv,D)
    out = torch.einsum("bkd,kd->bd", window, w) + b
    return F.silu(out), window[:, 1:]


def mamba_apply(cfg, p, x, *, cache: Optional[dict] = None, chunk: int = 64,
                ssd_impl: str = "kernel"):
    """Mamba2 block. x: (B,S,d). If cache given (decode, S==1): uses the
    recurrent step; cache = {'conv': (B,d_conv-1,convdim), 'ssm': (B,h,p,n)}.
    A prefill (S > 1) runs the chunk scan through ``kernels.ssd.ops.ssd``
    (``ssd_impl='kernel'``: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors; ``'ref'``: ``ssd_ref`` itself, as the
    reference's ``mamba_apply`` always runs it, and the only choice under
    autograd: the kernel has no backward) and, with a cache
    given, returns the state a decode continues from. The cache is read,
    never written: the caller stores the new state (gated, in place).
    Returns (out (B,S,d), new_cache)."""
    Bb, S, d = x.shape
    di, N, hp, H, G, conv_dim = _dims(cfg)

    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + conv_dim]
    dt_raw = zxbcdt[..., di + conv_dim:]  # (B,S,H)
    A = -torch.exp(p["A_log"])
    dt = F.softplus(dt_raw.float() + p["dt_bias"])

    if cache is not None and S == 1:
        xbc_t, new_conv = _conv_step(cache["conv"], xbc[:, 0], p["conv_w"], p["conv_b"])
        xs = xbc_t[:, :di].reshape(Bb, H, hp)
        Bmat = xbc_t[:, di: di + G * N].reshape(Bb, G, N)
        Cmat = xbc_t[:, di + G * N:].reshape(Bb, G, N)
        y, new_ssm = ssd_decode_step(cache["ssm"], xs, dt[:, 0], A, Bmat, Cmat)
        y = y + p["D"][:, None] * xs.float()
        y = y.reshape(Bb, 1, di)
        new_cache = {"conv": new_conv, "ssm": new_ssm}
    else:
        from repro_torch.kernels.ssd import ops as SSD

        if G != 1:
            raise NotImplementedError(f"ssm_ngroups={G}: the SSD scan takes one group")
        # causal depthwise conv over the sequence
        pad = torch.zeros((Bb, cfg.d_conv - 1, conv_dim), dtype=xbc.dtype, device=x.device)
        xpad = torch.cat([pad, xbc], dim=1)
        windows = xpad.unfold(1, cfg.d_conv, 1)  # (B,S,convdim,d_conv)
        # contiguous: the einsum may leave channels strided on the card, and
        # the SSD kernel reads x, B and C rows with a unit stride
        xbc_c = F.silu(torch.einsum("bsdk,kd->bsd", windows, p["conv_w"]) + p["conv_b"])
        xbc_c = xbc_c.contiguous()
        xs = xbc_c[..., :di].reshape(Bb, S, H, hp)
        Bmat = xbc_c[..., di: di + N]
        Cmat = xbc_c[..., di + N:]
        if ssd_impl == "kernel":
            y, final = SSD.ssd(xs.transpose(1, 2), dt.transpose(1, 2), A, Bmat, Cmat,
                               chunk=chunk)
            y = y.transpose(1, 2)  # (B,S,H,hp)
        else:  # the plain scan, called directly: a loss differentiates through it
            ck = chunk if S % chunk == 0 else S
            y, final = ssd_ref(xs, dt, A, Bmat[:, :, None], Cmat[:, :, None], chunk=ck)
        y = y + p["D"][None, None, :, None] * xs.float()
        y = y.reshape(Bb, S, di)
        new_cache = None
        if cache is not None:  # prefill: the state a decode continues from
            # conv state = the last (d_conv-1) inputs
            new_cache = {"conv": xpad[:, xpad.shape[1] - (cfg.d_conv - 1):], "ssm": final}

    y = y.to(x.dtype) * F.silu(z)
    y = rms_norm(y, p["norm_w"])
    return y @ p["out_proj"], new_cache


def mamba_cache_schema(cfg, batch: int, L=None, bspec="data") -> dict:
    """One recurrent state ``{conv, ssm}`` per row of ``batch``: the
    contiguous cache's rows, or, with ``batch = n_blocks``, the paged pool's
    STATE PAGES. A slot's whole state lives in the page at its FIRST
    block-table entry, and decode reads and writes it through the table.
    State is per slot (not per token), so prefix sharing and CoW degenerate
    to private allocation (the runner refuses sharing for mamba plans). The
    reference's ``mamba_paged_cache_schema`` differs from its contiguous one
    in sharding specs only: the rows over ``bspec`` (``"data"``; None for
    the pool's pages)."""
    _, N, hp, H, _, conv_dim = _dims(cfg)
    pre = () if L is None else (L,)
    pfx = (None,) * len(pre)
    return {
        "conv": ParamInfo(pre + (batch, cfg.d_conv - 1, conv_dim), torch_dtype(cfg.dtype),
                          "zeros", (*pfx, bspec, None, "model")),
        "ssm": ParamInfo(pre + (batch, H, hp, N), torch.float32, "zeros",
                         (*pfx, bspec, "model", None, None)),
    }
