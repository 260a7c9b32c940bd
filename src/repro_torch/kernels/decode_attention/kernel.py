"""ctypes wrappers of the CUDA flash-decode kernels (``csrc/decode_attention.cu``,
``csrc/paged_mla_decode.cu``).

``decode_attention`` replaces the JAX package's Pallas ``decode_attention``:
it reads k and v by stride, so the caller's (B, KH, S, hd) view of a
(B, S, KH, hd) cache costs no copy, and pos as the caller holds it.
``paged_decode_attention`` replaces the Pallas ``paged_decode_attention``:
the same kernel, instantiated to walk a per-row block table over (P, bs,
KH, hd) pools. In bfloat16 both cut each row's key axis into
``decode_splits`` ranges, one CTA each, merged inside the launch. ``paged_mla_decode_attention``
replaces the Pallas ``paged_mla_decode_attention``: absorbed MLA decode over
paged latent pools, one CTA per row and key range (``mla_splits``) serving
all heads, a second kernel merging the ranges. All launch on PyTorch's
current stream and never sync. Each has a ``*_meta`` twin that runs its
checks and the C entry point's on meta tensors (package docstring).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import H100_SMS, KernelShapeError
from repro_torch.kernels.build import check_launch, load

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# each C entry point's source and arguments
_ARGS = {"decode_attention_launch":
             ("decode_attention", [_P] * 7 + [_I] * 6 + [_L] * 10 + [_I, ctypes.c_float, _I, _P]),
         "paged_decode_attention_launch":
             ("decode_attention", [_P] * 8 + [_I] * 8 + [_L] * 11 + [_I, ctypes.c_float, _I, _P]),
         "decode_attention_ctas_per_sm": ("decode_attention", [_I] * 6),
         "paged_mla_decode_attention_launch":
             ("paged_mla_decode", [_P] * 8 + [_I] * 8 + [_L] * 11 + [_I, ctypes.c_float, _I, _P]),
         "paged_mla_decode_ctas_per_sm": ("paged_mla_decode", [_I] * 7)}
_MISALIGNED = 716  # cudaErrorMisalignedAddress, returned before any launch
_DECODE_ALIGN = ("k and v need 16-byte aligned bases and rows (bfloat16 q 4-byte aligned "
                 "pairs)")
_MLA_ALIGN = ("c_pool and kpe_pool (bfloat16: q_lat and q_pe too) need 16-byte aligned bases "
              "and rows")
_fns = {}


def _fn(name="decode_attention_launch"):
    fn = _fns.get(name)
    if fn is None:
        src, args = _ARGS[name]
        fn = getattr(load(src), name)
        fn.argtypes = args
        fn.restype = _I
        _fns[name] = fn
    return fn


DECODE_TILE = 16  # keys of a warp tile of the bf16 kernel; a key range is whole tiles
# what the bf16 kernel's shared memory lets an SM hold, by head width: 70 KB
# at hd 128, 132 KB at hd 256
DECODE_CTAS_PER_SM = {64: 3, 128: 3, 256: 1}
# CTAs for a wave and a half: ranges that start past their row's keys exit
# at once, so rows shorter than the cache leave slots that more ranges fill
DECODE_WAVES = 1.5
# the fewest tiles a range (four a warp of the CTA's four): a shorter row
# takes one range, since the merge's round trips through L2 cost more than a
# shorter walk saves
DECODE_RANGE_TILES = 16
DECODE_MAX_SPLITS = 256  # the kernel's merge keeps a weight a range and head in shared memory


def decode_splits(n_sm, B, KH, keys, hd=128):
    """Key ranges per (row, KV head) of the bf16 flash-decode kernel over
    ``keys`` cache slots (S, or nb * bs paged), from static shapes only, so
    that a captured launch stays valid: enough CTAs for DECODE_WAVES waves
    of ``n_sm`` SMs at DECODE_CTAS_PER_SM[hd] each, ranges of whole tiles,
    at least DECODE_RANGE_TILES of them, none past the last tile."""
    tiles = -(-keys // DECODE_TILE)
    want = math.ceil(DECODE_WAVES * n_sm * DECODE_CTAS_PER_SM[hd] / max(1, B * KH))
    want = max(1, min(want, tiles // DECODE_RANGE_TILES, DECODE_MAX_SPLITS))
    return -(-tiles // -(-tiles // want))  # ranges of ceil(tiles / want) tiles


_n_sm = {}
_splits_of = {}  # (device, dtype, B * KH, keys, hd) -> decode_splits
_scratch = {}  # (device, stream) -> [counters, partials]
_retired = []  # workspaces growth replaced: graphs captured over them still write them
# the head widths the kernel takes
_SCALE = {64: 1.0 / 8.0, 128: 1.0 / math.sqrt(128), 256: 1.0 / 16.0}
_POS_KINDS = {torch.int32: 0, torch.int64: 1}  # and 2: a Python int


def _sm_count(dev):
    n = _n_sm.get(dev)
    if n is None:
        n = _n_sm[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def _splits(dev, dtype, B, KH, keys, hd):
    key = (dev, dtype, B * KH, keys, hd)
    s = _splits_of.get(key)
    if s is None:
        # the f32 kernel takes the whole key axis in one CTA
        s = decode_splits(_sm_count(dev), B, KH, keys, hd) if dtype == torch.bfloat16 else 1
        _splits_of[key] = s
    return s


def _workspace(dev, stream, groups, floats):
    """Pointers to the merge's counters (int32, zero between calls: the
    kernel resets them) and its f32 partials, cached per device and stream
    and grown as needed, so a call allocates nothing.

    A CUDA graph captured over a workspace writes it on every replay, so
    growth keeps the tensors it replaces (``_retired``; they are small) and
    growth inside a capture raises: a run of the same call on the capture
    stream sizes them first."""
    w = _scratch.get((dev, stream))
    if w is None:
        w = _scratch[(dev, stream)] = [None, None]
    grow_cnt = w[0] is None or w[0].numel() < groups
    grow_part = w[1] is None or w[1].numel() < floats
    if (grow_cnt or grow_part) and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("decode attention: its workspace would grow inside a CUDA graph "
                           "capture; run the same call on the capture stream first")
    _retired.extend(t for t, grow in zip(w, (grow_cnt, grow_part)) if grow and t is not None)
    if grow_cnt:
        w[0] = torch.zeros(max(groups, 1024), dtype=torch.int32, device=dev)
    if grow_part:
        w[1] = torch.empty(max(floats, 1 << 18), dtype=torch.float32, device=dev)
    return w[0].data_ptr(), w[1].data_ptr()


def _refuse(what, q, k, v, hd, H, KH, on_card=True):
    """Raise the reason q, k and v are refused, if any: not on one card (or,
    ``on_card`` false, not all on meta), dtypes apart or not float32/bfloat16,
    a strided last dim, heads the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if on_card and (not t.is_cuda or t.get_device() != q.get_device()):
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {q.device}")
        if not on_card and t.device.type != "meta":
            raise ValueError(f"{what}: {name} must be a meta tensor, beside q")
        if t.dtype != q.dtype or q.dtype not in _DTYPES:
            raise ValueError(f"{what}: {name} dtype {t.dtype}; needs one of "
                             "float32/bfloat16, alike for q, k, v")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last dim")
    if hd not in _SCALE or KH == 0 or H % KH or H > 8 * KH:
        raise KernelShapeError(f"{what}: needs hd in (64, 128, 256) and H/KH <= 8, "
                               f"got hd={hd} H={H} KH={KH}")


def _operands(what, q, k, v, hd, H, KH):
    """q's device index, once q, k and v are on one card in one dtype with a
    contiguous last dim and heads the kernel takes (alignment is the C entry
    point's check). One test on the common path; the reason on the other."""
    dev, dt = q.get_device(), q.dtype
    if (dev < 0 or k.get_device() != dev or v.get_device() != dev or k.dtype != dt
            or v.dtype != dt or dt not in _DTYPES or q.stride(-1) != 1 or k.stride(-1) != 1
            or v.stride(-1) != 1 or hd not in _SCALE or KH == 0 or H % KH or H > 8 * KH):
        _refuse(what, q, k, v, hd, H, KH)
    return dev


def _aligned(t, dims, esize, to=16):
    """The C entry points' alignment test from strides alone (a meta tensor
    has no address): each stride of ``dims`` whose size exceeds 1 (a size-1
    dim is read at index 0 only) a multiple of ``to`` bytes."""
    return all(t.shape[i] == 1 or (t.stride(i) * esize) % to == 0 for i in dims)


def _meta_pos(pos, B, what):
    if isinstance(pos, torch.Tensor):
        if pos.device.type != "meta":
            raise ValueError(f"{what}: pos must be a meta tensor, beside q")
        n = pos.reshape(-1).shape[0]
        if n != B and n != 1:
            raise ValueError(f"{what}: pos has {n} values for {B} rows")


def _decode_meta(what, q, k, v, pos, H, KH, keys, hd, stride_dims):
    """The flash-decode contract on meta tensors: the wrapper's checks, then
    the C entry point's (cache slots, alignment from strides, the key
    ranges on an H100). Returns the (B, H, hd) output."""
    _refuse(what, q, k, v, hd, H, KH, on_card=False)
    B = q.shape[0]
    _meta_pos(pos, B, what)
    if B == 0:  # the wrapper returns before the C entry point
        return q.new_empty((B, H, hd))
    if keys < 1:
        raise ValueError(f"{what}: needs at least one key slot, got {keys}")
    es = q.element_size()
    if (not all(_aligned(t, stride_dims, es) for t in (k, v))
            or (q.dtype == torch.bfloat16 and not _aligned(q, (0, 1), es, 4))):
        raise ValueError(f"{what}: {_DECODE_ALIGN}, got strides "
                         + ", ".join(str(t.stride()) for t in (q, k, v)))
    if q.dtype == torch.bfloat16:
        splits = decode_splits(H100_SMS, B, KH, keys, hd)
        if not 1 <= splits <= min(DECODE_MAX_SPLITS, -(-keys // DECODE_TILE)):
            raise KernelShapeError(f"{what}: {splits} key ranges over {keys} slots")
    return q.new_empty((B, H, hd))


def _pos_args(pos, B, dev, what):
    """(pointer, element stride, scalar, kind) of pos for the C entry points:
    an int32 or int64 tensor on q's card is read as it is, one value a row
    or one for all; a Python int goes by value."""
    if not isinstance(pos, torch.Tensor):
        return None, 0, int(pos), 2
    if pos.get_device() != dev or pos.dtype not in _POS_KINDS:
        pos = pos.to(device=torch.device("cuda", dev), dtype=torch.int64)
    if pos.dim() != 1:
        pos = pos.reshape(-1)
    n = pos.shape[0]
    if n != B and n != 1:
        raise ValueError(f"{what}: pos has {n} values for {B} rows")
    return pos.data_ptr(), pos.stride(0) if n > 1 else 0, 0, _POS_KINDS[pos.dtype]


def _raise_on(rc, what, need, *tensors):
    if rc == _MISALIGNED:
        raise ValueError(f"{what}: {need}, got strides "
                         + ", ".join(str(t.stride()) for t in tensors))
    check_launch(rc, what)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos) -> torch.Tensor:
    """q (B, H, hd); k, v (B, KH, S, hd) views with a contiguous last dim and
    16-byte aligned rows; pos an int, or an int32/int64 tensor of B values or
    one (attend to key slots <= pos). Returns (B, H, hd) in q's dtype."""
    what = "decode_attention"
    B, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    KH, S = k.shape[1], k.shape[2]
    dev = _operands(what, q, k, v, hd, H, KH)
    pp, ps, pv, pk = _pos_args(pos, B, dev, what)
    out = q.new_empty((B, H, hd))
    if B == 0:
        return out
    # the raw current stream: torch.cuda.current_stream() builds a Stream object
    stream = torch._C._cuda_getCurrentRawStream(dev)
    splits = _splits(dev, q.dtype, B, KH, S, hd)
    cnt, part = _workspace(dev, stream, B * KH, B * H * splits * (hd + 2)) if splits > 1 \
        else (None, None)
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pp, out.data_ptr(), part, cnt, B, H, KH,
               S, hd, splits, qs[0], qs[1], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], ps, pv, pk,
               _SCALE[hd], _DTYPES[q.dtype], stream)
    if rc:
        _raise_on(rc, what, _DECODE_ALIGN, q, k, v)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos):
    """``decode_attention``'s contract on meta tensors: its checks, its (B,
    H, hd) output in q's dtype, no launch."""
    what = "decode_attention"
    B, H, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    KH, S = k.shape[1], k.shape[2]
    return _decode_meta(what, q, k, v, pos, H, KH, S, hd, (0, 1, 2))


# the bf16 kernel keeps its range's table entries in shared memory, the f32
# kernel its row's (at most 227 KB)
MAX_TABLE_BLOCKS = 16384


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           block_table: torch.Tensor, pos) -> torch.Tensor:
    """q (B, H, hd); k_pool, v_pool (P, bs, KH, hd) with a contiguous last
    dim and 16-byte aligned rows; block_table int (B, nb), row b's virtual
    block j at pool block ``block_table[b, j]`` (an int32 table with a
    contiguous last dim is read as it is); pos as for ``decode_attention``
    (attend to virtual slots <= pos, walked up to nb*bs - 1). Returns
    (B, H, hd) in q's dtype."""
    what = "paged_decode_attention"
    B, H, hd = q.shape
    if (k_pool.dim() != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != hd
            or block_table.dim() != 2 or block_table.shape[0] != B):
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} "
                         f"pools {tuple(k_pool.shape)} {tuple(v_pool.shape)} "
                         f"table {tuple(block_table.shape)}")
    P, bs, KH, _ = k_pool.shape
    nb = block_table.shape[1]
    dev = _operands(what, q, k_pool, v_pool, hd, H, KH)
    table = block_table
    if table.get_device() != dev:
        raise ValueError(f"{what}: block_table must be on {q.device}")
    if not 1 <= nb <= MAX_TABLE_BLOCKS or P < 1:
        raise KernelShapeError(f"{what}: needs 1 <= nb <= {MAX_TABLE_BLOCKS} "
                         f"and a non-empty pool, got nb={nb} P={P}")
    if table.dtype != torch.int32 or table.stride(1) != 1:
        table = table.to(torch.int32).contiguous()
    pp, ps, pv, pk = _pos_args(pos, B, dev, what)
    out = q.new_empty((B, H, hd))
    if B == 0:
        return out
    stream = torch._C._cuda_getCurrentRawStream(dev)
    splits = _splits(dev, q.dtype, B, KH, nb * bs, hd)
    cnt, part = _workspace(dev, stream, B * KH, B * H * splits * (hd + 2)) if splits > 1 \
        else (None, None)
    qs, ks, vs = q.stride(), k_pool.stride(), v_pool.stride()
    rc = _fn("paged_decode_attention_launch")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(), pp,
        out.data_ptr(), part, cnt, B, H, KH, P, bs, nb, hd, splits, qs[0], qs[1], ks[0], ks[1],
        ks[2], vs[0], vs[1], vs[2], table.stride(0), ps, pv, pk, _SCALE[hd], _DTYPES[q.dtype],
        stream)
    if rc:
        _raise_on(rc, what, _DECODE_ALIGN, q, k_pool, v_pool)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_meta(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                                block_table: torch.Tensor, pos):
    """``paged_decode_attention``'s contract on meta tensors: its checks, its
    (B, H, hd) output in q's dtype, no launch."""
    what = "paged_decode_attention"
    B, H, hd = q.shape
    if (k_pool.dim() != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != hd
            or block_table.dim() != 2 or block_table.shape[0] != B):
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} "
                         f"pools {tuple(k_pool.shape)} {tuple(v_pool.shape)} "
                         f"table {tuple(block_table.shape)}")
    P, bs, KH, _ = k_pool.shape
    nb = block_table.shape[1]
    if block_table.device.type != "meta":
        raise ValueError(f"{what}: block_table must be a meta tensor, beside q")
    if not 1 <= nb <= MAX_TABLE_BLOCKS or P < 1:
        raise KernelShapeError(f"{what}: needs 1 <= nb <= {MAX_TABLE_BLOCKS} "
                               f"and a non-empty pool, got nb={nb} P={P}")
    return _decode_meta(what, q, k_pool, v_pool, pos, H, KH, nb * bs, hd, (0, 1, 2))


def decode_launch_info(dtype, B, H, KH, keys, hd=128, *, paged=False, bs=1, device=0):
    """The split count and the CTAs an SM (as the card's occupancy API
    reports them) of a flash-decode launch over ``keys`` slots: what
    chip_smoke.py prints beside the kernel rows."""
    splits = _splits(device, dtype, B, KH, keys, hd)
    n = _fn("decode_attention_ctas_per_sm")(_DTYPES[dtype], hd, int(paged), keys, bs, splits)
    if n < 0:
        check_launch(-n, "decode_attention_ctas_per_sm")
    return {"splits": splits, "ctas": B * KH * splits, "ctas_per_sm": n}


MLA_MAX_HEADS, MLA_MAX_RANK, MLA_MAX_WIDTH = 16, 512, 1024  # H, r, r + dr the kernel takes
MLA_TILE = 32  # keys a tile; a key range is a whole number of tiles
# what the kernels' shared memory lets an SM hold at DeepSeek's widths: the
# bf16 kernel's ~105 KB two, the f32 kernel's ~113 KB one
MLA_CTAS_PER_SM = {torch.bfloat16: 2, torch.float32: 1}
# CTAs for a wave and a half, of which rows of uniformly drawn lengths keep
# about half live (ranges past a row's keys exit at once): at B 32 x 4096
# keys on an H100, 13 ranges kept the live CTAs inside one wave of two an SM
# where 16 spilled past it and took longer (tools/mla_ssd_probe.py)
MLA_WAVES = 1.5
MLA_MAX_SPLITS = 128  # the merge keeps each range's weight in shared memory


def mla_splits(n_sm, B, keys, ctas_per_sm=MLA_CTAS_PER_SM[torch.bfloat16]):
    """Key ranges per row of the paged MLA kernel over ``keys`` table slots
    (nb * bs), from static shapes only, so that a captured launch stays
    valid: enough CTAs for MLA_WAVES waves of ``n_sm`` SMs at
    ``ctas_per_sm`` each, ranges of whole tiles, none past the last tile."""
    tiles = -(-keys // MLA_TILE)
    want = math.ceil(MLA_WAVES * n_sm * ctas_per_sm / max(1, B))
    want = max(1, min(want, tiles, MLA_MAX_SPLITS))
    return -(-tiles // -(-tiles // want))  # ranges of ceil(tiles / want) tiles


_mla_splits_of = {}  # (device, dtype, B, keys) -> mla_splits


def _mla_splits(dev, dtype, B, keys):
    key = (dev, dtype, B, keys)
    s = _mla_splits_of.get(key)
    if s is None:
        s = _mla_splits_of[key] = mla_splits(_sm_count(dev), B, keys, MLA_CTAS_PER_SM[dtype])
    return s


def _mla_refuse(what, q_lat, q_pe, c_pool, kpe_pool, block_table, H, r, dr, nb, P, bs,
                on_card=True):
    """Raise the reason the MLA operands are refused, if any (on the card,
    the slow path; ``on_card`` false: every operand on meta)."""
    dev = q_lat.device
    for name, t in (("q_lat", q_lat), ("q_pe", q_pe), ("c_pool", c_pool),
                    ("kpe_pool", kpe_pool)):
        if on_card and (t.device.type != "cuda" or t.device != dev):
            raise ValueError(f"{what}: {name} must be a CUDA tensor on {dev}")
        if not on_card and t.device.type != "meta":
            raise ValueError(f"{what}: {name} must be a meta tensor, beside q_lat")
        if t.dtype != q_lat.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{what}: {name} dtype {t.dtype}; needs one of "
                             "float32/bfloat16, alike for all four")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last dim")
    if block_table.device != dev:
        raise ValueError(f"{what}: block_table must be on {dev}")
    if not (1 <= H <= MLA_MAX_HEADS and 8 <= r <= MLA_MAX_RANK and r % 8 == 0
            and dr >= 8 and dr % 8 == 0 and r + dr <= MLA_MAX_WIDTH):
        raise KernelShapeError(f"{what}: needs H <= {MLA_MAX_HEADS}, r <= {MLA_MAX_RANK}, r "
                               f"and dr multiples of 8 and r + dr <= {MLA_MAX_WIDTH}, "
                               f"got H={H} r={r} dr={dr}")
    if not 1 <= nb <= MAX_TABLE_BLOCKS or P < 1 or bs < 1:
        raise KernelShapeError(f"{what}: needs 1 <= nb <= {MAX_TABLE_BLOCKS} and a non-empty "
                               f"pool, got nb={nb} P={P} bs={bs}")


def paged_mla_decode_attention(q_lat: torch.Tensor, q_pe: torch.Tensor, c_pool: torch.Tensor,
                               kpe_pool: torch.Tensor, block_table: torch.Tensor, pos, *,
                               scale: float) -> torch.Tensor:
    """q_lat (B, H, r) absorbed query; q_pe (B, H, dr) rope query (bfloat16
    rows 16-byte aligned); c_pool (P, bs, r) latent pool (keys and values);
    kpe_pool (P, bs, dr) rope-key pool, both with a contiguous last dim and
    16-byte aligned rows; block_table int (B, nb) (an int32 table with a
    contiguous last dim is read as it is); pos as for ``decode_attention``
    (attend to virtual slots <= pos, walked up to nb*bs - 1); ``scale``
    multiplies the scores (1/sqrt(dn + dr) in MLA). Returns (B, H, r) in
    q_lat's dtype."""
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
    dev, dt = q_lat.get_device(), q_lat.dtype
    if (dev < 0 or q_pe.get_device() != dev or c_pool.get_device() != dev
            or kpe_pool.get_device() != dev or block_table.get_device() != dev
            or q_pe.dtype != dt or c_pool.dtype != dt or kpe_pool.dtype != dt
            or dt not in _DTYPES or q_lat.stride(-1) != 1 or q_pe.stride(-1) != 1
            or c_pool.stride(-1) != 1 or kpe_pool.stride(-1) != 1
            or not (1 <= H <= MLA_MAX_HEADS and 8 <= r <= MLA_MAX_RANK and r % 8 == 0
                    and dr >= 8 and dr % 8 == 0 and r + dr <= MLA_MAX_WIDTH)
            or not 1 <= nb <= MAX_TABLE_BLOCKS or P < 1 or bs < 1):
        _mla_refuse(what, q_lat, q_pe, c_pool, kpe_pool, block_table, H, r, dr, nb, P, bs)
    table = block_table
    if table.dtype != torch.int32 or table.stride(1) != 1:
        table = table.to(torch.int32).contiguous()
    pp, ps, pv, pk = _pos_args(pos, B, dev, what)
    out = q_lat.new_empty((B, H, r))
    if B == 0:
        return out
    stream = torch._C._cuda_getCurrentRawStream(dev)
    splits = _mla_splits(dev, dt, B, nb * bs)
    part = _workspace(dev, stream, 0, B * splits * (H * r + 2 * MLA_MAX_HEADS))[1] \
        if splits > 1 else None
    qs, es, cs, ks = q_lat.stride(), q_pe.stride(), c_pool.stride(), kpe_pool.stride()
    rc = _fn("paged_mla_decode_attention_launch")(
        q_lat.data_ptr(), q_pe.data_ptr(), c_pool.data_ptr(), kpe_pool.data_ptr(),
        table.data_ptr(), pp, out.data_ptr(), part, B, H, r, dr, P, bs, nb, splits, qs[0],
        qs[1], es[0], es[1], cs[0], cs[1], ks[0], ks[1], table.stride(0), ps, pv, pk, scale,
        _DTYPES[dt], stream)
    if rc:
        _raise_on(rc, what, _MLA_ALIGN, q_lat, q_pe, c_pool, kpe_pool)
    paged_mla_decode_attention.launches += 1
    return out


paged_mla_decode_attention.launches = 0


def paged_mla_decode_attention_meta(q_lat: torch.Tensor, q_pe: torch.Tensor,
                                    c_pool: torch.Tensor, kpe_pool: torch.Tensor,
                                    block_table: torch.Tensor, pos, *, scale: float):
    """``paged_mla_decode_attention``'s contract on meta tensors: its checks,
    the C entry point's (alignment from strides, the key ranges on an
    H100), its (B, H, r) output in q_lat's dtype, no launch."""
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
    _mla_refuse(what, q_lat, q_pe, c_pool, kpe_pool, block_table, H, r, dr, nb, P, bs,
                on_card=False)
    _meta_pos(pos, B, what)
    if B == 0:  # the wrapper returns before the C entry point
        return q_lat.new_empty((B, H, r))
    es = q_lat.element_size()
    qa = 16 if q_lat.dtype == torch.bfloat16 else 4  # bf16 q rows go by TMA
    if (not all(_aligned(t, (0, 1), es) for t in (c_pool, kpe_pool))
            or not all(_aligned(t, (0, 1), es, qa) for t in (q_lat, q_pe))):
        raise ValueError(f"{what}: {_MLA_ALIGN}, got strides "
                         + ", ".join(str(t.stride()) for t in (q_lat, q_pe, c_pool, kpe_pool)))
    splits = mla_splits(H100_SMS, B, nb * bs, MLA_CTAS_PER_SM[q_lat.dtype])
    if not 1 <= splits <= min(MLA_MAX_SPLITS, -(-(nb * bs) // MLA_TILE)):
        raise KernelShapeError(f"{what}: {splits} key ranges over {nb * bs} slots")
    return q_lat.new_empty((B, H, r))


def mla_launch_info(dtype, B, H, r, dr, bs, nb, device=0):
    """The split count and the CTAs an SM (as the card's occupancy API
    reports them) of a paged MLA launch: what chip_smoke.py prints beside
    the kernel rows."""
    splits = _mla_splits(device, dtype, B, nb * bs)
    n = _fn("paged_mla_decode_ctas_per_sm")(_DTYPES[dtype], H, r, dr, bs, nb, splits)
    if n < 0:
        check_launch(-n, "paged_mla_decode_ctas_per_sm")
    return {"splits": splits, "ctas": B * splits, "ctas_per_sm": n}
