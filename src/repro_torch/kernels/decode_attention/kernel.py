"""ctypes wrappers of the CUDA flash-decode kernels (``csrc/decode_attention.cu``,
``csrc/paged_mla_decode.cu``).

``decode_attention`` replaces the JAX package's Pallas ``decode_attention``:
it reads k and v by stride, so the caller's (B, KH, S, hd) view of a
(B, S, KH, hd) cache costs no copy. ``paged_decode_attention`` replaces the
Pallas ``paged_decode_attention``: the same kernel, instantiated to walk a
per-row block table over (P, bs, KH, hd) pools. ``paged_mla_decode_attention``
replaces the Pallas ``paged_mla_decode_attention``: absorbed MLA decode over
paged latent pools, one CTA per row and key range serving all heads. All
launch on PyTorch's current stream and never sync.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import check_launch, load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# each C entry point's leading arguments: pointers, ints, strides
_ARGS = {"decode_attention_launch": [_P] * 5 + [_I] * 5 + [_L] * 8,
         "paged_decode_attention_launch": [_P] * 6 + [_I] * 7 + [_L] * 8}


def _fn(name="decode_attention_launch"):
    fn = getattr(load("decode_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGS[name] + [ctypes.c_float, _I, _P]
        fn.restype = _I
    return fn


def _check_16b(name, t, what="decode_attention"):
    if t.data_ptr() % 16 or any((s * t.element_size()) % 16 for s in t.stride()[:-1]):
        raise ValueError(f"{what}: {name} rows must be 16-byte aligned "
                         f"(strides {t.stride()})")


def _check_operands(what, q, kv, hd, H, KH):
    """Device, dtype, contiguous last dim and the shapes the kernel takes."""
    for name, t in (("q", q),) + kv:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {q.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{what}: {name} dtype {t.dtype}; needs one of "
                             "float32/bfloat16, alike for q, k, v")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last dim")
    if hd not in (64, 128) or KH == 0 or H % KH or H // KH > 8:
        raise ValueError(f"{what}: needs hd in (64, 128) and H/KH <= 8, "
                         f"got hd={hd} H={H} KH={KH}")
    for name, t in kv:
        _check_16b(name, t, what)


def _pos_vector(pos, B, device):
    if torch.is_tensor(pos):
        return pos.to(device=device, dtype=torch.int32).reshape(-1).expand(B).contiguous()
    return torch.full((B,), int(pos), dtype=torch.int32, device=device)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos) -> torch.Tensor:
    """q (B, H, hd); k, v (B, KH, S, hd) views with a contiguous last dim;
    pos an int or an int (B,) tensor (attend to key slots <= pos).
    Returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    KH, S = k.shape[1], k.shape[2]
    _check_operands("decode_attention", q, (("k", k), ("v", v)), hd, H, KH)
    pos = _pos_vector(pos, B, q.device)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    fn = _fn()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(),
            B, H, KH, S, hd, q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# the block table lives in shared memory beside the tiles (at most 227 KB)
MAX_TABLE_BLOCKS = 16384


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           block_table: torch.Tensor, pos) -> torch.Tensor:
    """q (B, H, hd); k_pool, v_pool (P, bs, KH, hd) with a contiguous last
    dim; block_table int (B, nb), row b's virtual block j at pool block
    ``block_table[b, j]``; pos an int or an int (B,) tensor (attend to
    virtual slots <= pos, walked up to nb*bs - 1). Returns (B, H, hd) in
    q's dtype."""
    B, H, hd = q.shape
    if (k_pool.dim() != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != hd
            or block_table.dim() != 2 or block_table.shape[0] != B):
        raise ValueError(f"paged_decode_attention: bad shapes q {tuple(q.shape)} "
                         f"pools {tuple(k_pool.shape)} {tuple(v_pool.shape)} "
                         f"table {tuple(block_table.shape)}")
    P, bs, KH, _ = k_pool.shape
    nb = block_table.shape[1]
    _check_operands("paged_decode_attention", q, (("k_pool", k_pool), ("v_pool", v_pool)),
                    hd, H, KH)
    if block_table.device != q.device:
        raise ValueError(f"paged_decode_attention: block_table must be on {q.device}")
    if not 1 <= nb <= MAX_TABLE_BLOCKS or P < 1:
        raise ValueError(f"paged_decode_attention: needs 1 <= nb <= {MAX_TABLE_BLOCKS} "
                         f"and a non-empty pool, got nb={nb} P={P}")
    table = block_table.to(torch.int32).contiguous()
    pos = _pos_vector(pos, B, q.device)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    fn = _fn("paged_decode_attention_launch")
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, H, KH, P, bs, nb, hd, q.stride(0), q.stride(1),
            k_pool.stride(0), k_pool.stride(1), k_pool.stride(2),
            v_pool.stride(0), v_pool.stride(1), v_pool.stride(2), 1.0 / math.sqrt(hd),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


_MLA_ARGS = [_P] * 8 + [_I] * 8 + [_L] * 8 + [ctypes.c_float, _I, _P]
MLA_MAX_HEADS, MLA_MAX_RANK = 16, 512  # the kernel's register and thread layout
MLA_TILE = 32  # keys per tile; a key range is a whole number of tiles


def mla_splits(n_sm, B, keys):
    """Key ranges per row for ``keys`` table slots: enough CTAs to fill the
    ``n_sm`` SMs once (one CTA fits an SM), ranges of whole tiles, none of
    them past the last tile."""
    tiles = -(-keys // MLA_TILE)
    want = max(1, min(tiles, n_sm // B))
    return -(-tiles // -(-tiles // want))  # ranges of ceil(tiles / want) tiles


def paged_mla_decode_attention(q_lat: torch.Tensor, q_pe: torch.Tensor, c_pool: torch.Tensor,
                               kpe_pool: torch.Tensor, block_table: torch.Tensor, pos, *,
                               scale: float) -> torch.Tensor:
    """q_lat (B, H, r) absorbed query; q_pe (B, H, dr) rope query; c_pool
    (P, bs, r) latent pool (keys and values); kpe_pool (P, bs, dr) rope-key
    pool, both with a contiguous last dim and 16-byte aligned rows;
    block_table int (B, nb); pos an int or an int (B,) tensor (attend to
    virtual slots <= pos, walked up to nb*bs - 1); ``scale`` multiplies the
    scores (1/sqrt(dn + dr) in MLA). Returns (B, H, r) in q_lat's dtype."""
    what = "paged_mla_decode_attention"
    B, H, r = q_lat.shape
    if (q_pe.dim() != 3 or q_pe.shape[:2] != (B, H) or c_pool.dim() != 3
            or c_pool.shape[2] != r or kpe_pool.dim() != 3
            or kpe_pool.shape[:2] != c_pool.shape[:2] or kpe_pool.shape[2] != q_pe.shape[2]
            or block_table.dim() != 2 or block_table.shape[0] != B):
        raise ValueError(f"{what}: bad shapes q_lat {tuple(q_lat.shape)} "
                         f"q_pe {tuple(q_pe.shape)} c_pool {tuple(c_pool.shape)} "
                         f"kpe_pool {tuple(kpe_pool.shape)} table {tuple(block_table.shape)}")
    P, bs, _ = c_pool.shape
    dr, nb = q_pe.shape[2], block_table.shape[1]
    for name, t in (("q_lat", q_lat), ("q_pe", q_pe), ("c_pool", c_pool),
                    ("kpe_pool", kpe_pool)):
        if t.device.type != "cuda" or t.device != q_lat.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {q_lat.device}")
        if t.dtype != q_lat.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{what}: {name} dtype {t.dtype}; needs one of "
                             "float32/bfloat16, alike for all four")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last dim")
    if not (1 <= H <= MLA_MAX_HEADS and 8 <= r <= MLA_MAX_RANK and r % 8 == 0
            and dr >= 8 and dr % 8 == 0):
        raise ValueError(f"{what}: needs H <= {MLA_MAX_HEADS}, r <= {MLA_MAX_RANK} and "
                         f"r, dr multiples of 8, got H={H} r={r} dr={dr}")
    _check_16b("c_pool", c_pool, what)
    _check_16b("kpe_pool", kpe_pool, what)
    if block_table.device != q_lat.device:
        raise ValueError(f"{what}: block_table must be on {q_lat.device}")
    if not 1 <= nb <= MAX_TABLE_BLOCKS or P < 1 or bs < 1:
        raise ValueError(f"{what}: needs 1 <= nb <= {MAX_TABLE_BLOCKS} and a non-empty "
                         f"pool, got nb={nb} P={P} bs={bs}")
    table = block_table.to(torch.int32).contiguous()
    pos = _pos_vector(pos, B, q_lat.device)
    out = torch.empty((B, H, r), dtype=q_lat.dtype, device=q_lat.device)
    if B == 0:
        return out
    splits = mla_splits(torch.cuda.get_device_properties(q_lat.device).multi_processor_count,
                        B, nb * bs)
    # each range's unnormalised (context, m, l) in f32, merged by a second kernel
    part = (torch.empty(B * splits * H * (r + 2), dtype=torch.float32, device=q_lat.device)
            if splits > 1 else None)
    fn = getattr(load("paged_mla_decode"), "paged_mla_decode_attention_launch")
    if fn.argtypes is None:
        fn.argtypes = _MLA_ARGS
        fn.restype = _I
    rc = fn(q_lat.data_ptr(), q_pe.data_ptr(), c_pool.data_ptr(), kpe_pool.data_ptr(),
            table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            part.data_ptr() if part is not None else None, B, H, r, dr, P, bs, nb, splits,
            q_lat.stride(0), q_lat.stride(1), q_pe.stride(0), q_pe.stride(1),
            c_pool.stride(0), c_pool.stride(1), kpe_pool.stride(0), kpe_pool.stride(1),
            float(scale), _DTYPES[q_lat.dtype], torch.cuda.current_stream(q_lat.device).cuda_stream)
    check_launch(rc, what)
    paged_mla_decode_attention.launches += 1
    return out


paged_mla_decode_attention.launches = 0
