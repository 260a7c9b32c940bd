"""On a CUDA card: each CUDA kernel against its plain PyTorch version (the
paged decode kernel also bit for bit against the contiguous one), the
tiny models with the kernels on against the plain path (tiny mamba2 and
qwen2 prefills through the SSD and flash-attention kernels too), the
runner's CUDA-graph sync windows against its eager ones, the
classifier runners (ResNet, BERT) against their CPU forward, and training:
a ramps_only step on the card against the CPU, the kernel dispatchers'
refusal under autograd, a bf16 checkpoint round trip. Every test is
marked `gpu` and skips without a card; the file imports no jax, so it runs
on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.kernels.decode_attention import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    decode_attention,
    decode_attention_ref,
    paged_decode_attention,
    paged_decode_attention_ref,
    paged_mla_decode_attention,
    paged_mla_decode_attention_ref,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    attention_ref,
    flash_attention,
)
from repro_torch.kernels.ramp_head import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    ramp_head_exit,
    ramp_head_exit_ref,
    ramp_head_stats,
)
from repro_torch.kernels.ssd import ssd, ssd_chunked  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels import counted_wrappers  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import tree_leaves  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.serving import DecodeRunner  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.serving.graphs import WindowGraphs  # noqa: E402  # repro: allow[tier1-deps] — the port under test

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="session")
def built():
    """Every kernel built (in parallel) before the first test runs. Where
    the kernels were built one by one at first use, between tests, the
    torch.profiler traces of the launch-only tests missed kernels in most
    runs that built them (``tools/card_test_flake_probe.py --fresh-build``);
    the cause is not known."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import build  # repro: allow[tier1-deps] — the port under test

    build.build()


@pytest.fixture
def gen(built):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions stay f32
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,H,KH,S", [(128, 12, 2, 77), (64, 16, 16, 300), (128, 8, 1, 33)])
def test_decode_kernel_matches_plain(gen, dtype, hd, H, KH, S):
    dt = getattr(torch, dtype)
    B = 5
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
    kc = torch.randn(B, S, KH, hd, generator=gen, device="cuda").to(dt)
    vc = torch.randn(B, S, KH, hd, generator=gen, device="cuda").to(dt)
    pos = torch.tensor([0, 1, S // 2, S - 1, S + 5], device="cuda")  # last: past the cache
    out = decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2), pos)
    ref = decode_attention_ref(q, kc.transpose(1, 2), vc.transpose(1, 2), pos)
    # f32: sums in another order (1e-5); bf16: one output rounding (1e-2)
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 48])  # 48 does not divide the f32 kernel's 32-key tile
def test_paged_kernel_matches_plain_and_contiguous(gen, dtype, hd, bs):
    """A shuffled table over a pool whose block 0 is the trash block. Row 1
    owns three blocks and points the rest at block 0; pos covers the first
    slot, both sides of a block boundary, the walk's clamp at nb*bs - 1 and
    a stale pos past the table."""
    dt = getattr(torch, dtype)
    B, H, KH, nb = 6, 8, 2, 5
    S, P = nb * bs, B * nb + 1
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
    k_pool = torch.randn(P, bs, KH, hd, generator=gen, device="cuda").to(dt)
    v_pool = torch.randn(P, bs, KH, hd, generator=gen, device="cuda").to(dt)
    table = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).reshape(B, nb)
    table = table.to(torch.int32)
    table[1, 3:] = 0
    pos = torch.tensor([0, 3 * bs - 1, bs - 1, bs, S - 1, S + 7], device="cuda")
    out = paged_decode_attention(q, k_pool, v_pool, table, pos)
    ref = paged_decode_attention_ref(q, k_pool, v_pool, table, pos)
    tol = 1e-5 if dtype == "float32" else 1e-2  # as for the contiguous kernel
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    kc = k_pool[table.long()].reshape(B, S, KH, hd)  # the same keys, contiguous
    vc = v_pool[table.long()].reshape(B, S, KH, hd)
    cont = decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2), pos)
    assert torch.equal(out, cont)  # same key order, same arithmetic


def _range_edges(chunk, S):
    """pos at the first slot, inside the first key range (so the later
    ranges are empty), both sides of the first two range boundaries, the
    last slot and past it."""
    return [0, 5, chunk - 2, chunk - 1, chunk, chunk + 1, 2 * chunk - 1, 2 * chunk,
            S - 1, S + 9]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 6, 8])
def test_decode_split_ranges_match_plain(gen, dtype, hd, G):
    """The key axis cut into ranges (bf16: 3 ranges of 336 keys for these 10
    rows): pos on every side of the range edges, S = 1000 not a multiple of
    the 16-key tile, int64 pos as the model holds it."""
    from repro_torch.kernels.decode_attention.kernel import DECODE_TILE, decode_launch_info  # repro: allow[tier1-deps] — the port under test

    dt = getattr(torch, dtype)
    KH, S = 2, 1000
    B = len(_range_edges(0, S))
    info = decode_launch_info(dt, B, G * KH, KH, S, hd)
    tiles = -(-S // DECODE_TILE)
    chunk = -(-tiles // info["splits"]) * DECODE_TILE
    if dtype == "bfloat16":
        assert info["splits"] > 2 and info["ctas_per_sm"] >= 2
    q = torch.randn(B, G * KH, hd, generator=gen, device="cuda").to(dt)
    kc = torch.randn(B, S, KH, hd, generator=gen, device="cuda").to(dt)
    vc = torch.randn(B, S, KH, hd, generator=gen, device="cuda").to(dt)
    pos = torch.tensor(_range_edges(chunk, S), device="cuda")  # int64
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)
    out = decode_attention(q, k, v, pos)
    ref = decode_attention_ref(q, k, v, pos)
    # f32: sums in another order (1e-5); bf16: one output rounding (1e-2)
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    # int32 pos, and one pos for every row (a tensor of one value, an int)
    torch.testing.assert_close(decode_attention(q, k, v, pos.to(torch.int32)), out, rtol=0, atol=0)
    one = decode_attention(q, k, v, pos[6:7])
    assert torch.equal(one, decode_attention(q, k, v, int(pos[6])))
    torch.testing.assert_close(one.float(), decode_attention_ref(q, k, v, pos[6]).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(200, 300), (4, 40)])
def test_decode_one_range_matches_plain(gen, dtype, B, S):
    """Shapes where the kernel takes each row's keys in one range: enough
    (row, KV head) pairs to fill the card, or too few tiles to split."""
    from repro_torch.kernels.decode_attention.kernel import decode_launch_info  # repro: allow[tier1-deps] — the port under test

    dt = getattr(torch, dtype)
    H, KH, hd = 12, 2, 128
    assert decode_launch_info(dt, B, H, KH, S, hd)["splits"] == 1
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
    kc = torch.randn(B, S, KH, hd, generator=gen, device="cuda").to(dt)
    vc = torch.randn(B, S, KH, hd, generator=gen, device="cuda").to(dt)
    pos = torch.randint(0, S + 4, (B,), generator=gen, device="cuda")
    out = decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2), pos)
    ref = decode_attention_ref(q, kc.transpose(1, 2), vc.transpose(1, 2), pos)
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16, 24, 48])  # 24: a 16-key tile spans two blocks
def test_paged_split_ranges_match_contiguous_bit_for_bit(gen, dtype, bs):
    """The paged kernel across key-range edges over a shuffled table (block
    0 the trash block no row owns): within tolerance of its plain version
    and bit for bit equal to the contiguous kernel on the same keys (same
    S, same ranges, same merge order)."""
    from repro_torch.kernels.decode_attention.kernel import DECODE_TILE, decode_launch_info  # repro: allow[tier1-deps] — the port under test

    dt = getattr(torch, dtype)
    H, KH, hd = 12, 2, 128
    nb = -(-960 // bs)
    S = nb * bs
    B = len(_range_edges(0, S))
    P = B * nb + 1
    info = decode_launch_info(dt, B, H, KH, S, hd, paged=True, bs=bs)
    tiles = -(-S // DECODE_TILE)
    chunk = -(-tiles // info["splits"]) * DECODE_TILE
    if dtype == "bfloat16":
        assert info["splits"] > 2
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
    k_pool = torch.randn(P, bs, KH, hd, generator=gen, device="cuda").to(dt)
    v_pool = torch.randn(P, bs, KH, hd, generator=gen, device="cuda").to(dt)
    table = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).reshape(B, nb)
    table = table.to(torch.int32)
    pos = torch.tensor(_range_edges(chunk, S), device="cuda")
    out = paged_decode_attention(q, k_pool, v_pool, table, pos)
    ref = paged_decode_attention_ref(q, k_pool, v_pool, table, pos)
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    kc = k_pool[table.long()].reshape(B, S, KH, hd)
    vc = v_pool[table.long()].reshape(B, S, KH, hd)
    assert torch.equal(out, decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2), pos))
    # an int64 table is taken too (converted once), with the same result
    assert torch.equal(out, paged_decode_attention(q, k_pool, v_pool, table.long(), pos))


def test_decode_wrappers_launch_only_their_kernel(gen):
    """On the model's operands (int64 pos, an int32 table) a call launches
    the attention kernel and nothing else: no cast, no copy, no fill, also
    where the key axis is split (the merge runs inside the kernel)."""
    dt = torch.bfloat16
    B, H, KH, hd, bs, nb = 8, 12, 2, 128, 16, 64
    S, P = nb * bs, B * nb + 1
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
    kc = torch.randn(B, S, KH, hd, generator=gen, device="cuda").to(dt)
    pool = torch.randn(P, bs, KH, hd, generator=gen, device="cuda").to(dt)
    table = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).reshape(B, nb)
    table = table.to(torch.int32)
    pos = torch.randint(S // 2, S, (B,), generator=gen, device="cuda")  # int64
    k = kc.transpose(1, 2)

    def calls():
        decode_attention(q, k, k, pos)
        paged_decode_attention(q, pool, pool, table, pos)

    calls()  # the first call sizes the merge's cached workspace
    torch.cuda.synchronize()
    n0 = (decode_attention.launches, paged_decode_attention.launches)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        calls()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 2 and all("decode_bf16_kernel" in n for n in names), names
    assert (decode_attention.launches, paged_decode_attention.launches) == (n0[0] + 1, n0[1] + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,r,dr", [(4, 32, 8), (16, 512, 64)])
@pytest.mark.parametrize("bs", [8, 16, 48])  # 48 does not divide the 32-key tile
def test_paged_mla_kernel_matches_plain(gen, dtype, H, r, dr, bs):
    """A shuffled table over a latent pool whose block 0 is the trash block.
    Row 1 owns three blocks and points the rest at block 0; pos covers the
    first slot, both sides of a block boundary, the walk's clamp at
    nb*bs - 1 and a stale pos past the table. q_pe is a strided view, as
    the model hands it over."""
    dt = getattr(torch, dtype)
    B, nb = 6, 5
    S, P = nb * bs, B * nb + 1
    q_lat = torch.randn(B, H, r, generator=gen, device="cuda").to(dt)
    q_pe = torch.randn(B, H, 16 + dr, generator=gen, device="cuda").to(dt)[..., 16:]
    c_pool = torch.randn(P, bs, r, generator=gen, device="cuda").to(dt)
    kpe_pool = torch.randn(P, bs, dr, generator=gen, device="cuda").to(dt)
    table = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).reshape(B, nb)
    table = table.to(torch.int32)
    table[1, 3:] = 0
    pos = torch.tensor([0, 3 * bs - 1, bs - 1, bs, S - 1, S + 7], device="cuda")
    scale = 1.0 / (128 + dr) ** 0.5
    out = paged_mla_decode_attention(q_lat, q_pe, c_pool, kpe_pool, table, pos, scale=scale)
    ref = paged_mla_decode_attention_ref(q_lat, q_pe, c_pool, kpe_pool, table, pos,
                                         scale=scale)
    # f32: sums in another order (1e-5); bf16: one output rounding (1e-2)
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_paged_mla_kernel_refuses_what_it_cannot_take(gen):
    q = torch.randn(2, 17, 64, generator=gen, device="cuda")  # 17 heads > 16
    pool = torch.randn(3, 4, 64, generator=gen, device="cuda")
    table = torch.ones(2, 2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        paged_mla_decode_attention(q, q[..., :8], pool, pool[..., :8], table, 3, scale=0.1)
    n0 = paged_mla_decode_attention.launches
    out = paged_mla_decode_attention(q[:0, :4], q[:0, :4, :8], pool, pool[..., :8].contiguous(),
                                     table[:0], 3, scale=0.1)
    assert out.shape == (0, 4, 64) and paged_mla_decode_attention.launches == n0


def _mla_inputs(gen, B, nb, bs, dt, H=16, r=512, dr=64):
    """A shuffled table over a latent pool whose block 0 is the trash block
    no row owns, q_pe a strided view as the model hands it over."""
    P = B * nb + 1
    q_lat = torch.randn(B, H, r, generator=gen, device="cuda").to(dt)
    q_pe = torch.randn(B, H, 16 + dr, generator=gen, device="cuda").to(dt)[..., 16:]
    c_pool = torch.randn(P, bs, r, generator=gen, device="cuda").to(dt)
    kpe_pool = torch.randn(P, bs, dr, generator=gen, device="cuda").to(dt)
    table = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).reshape(B, nb)
    return q_lat, q_pe, c_pool, kpe_pool, table.to(torch.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nb,one_range", [(32, 256, False), (8, 2, True), (600, 10, True)])
def test_paged_mla_split_ranges_match_plain(gen, dtype, B, nb, one_range):
    """DeepSeek's widths with each row's keys in many ranges (B 32 x 256
    blocks of 16: pos on every side of the range edges, and random) or in
    one (two blocks: too few tiles to split; B 600: enough rows to fill the
    card), int64 pos as the model holds it."""
    from repro_torch.kernels.decode_attention.kernel import MLA_TILE, mla_launch_info  # repro: allow[tier1-deps] — the port under test

    dt, bs = getattr(torch, dtype), 16
    S = nb * bs
    info = mla_launch_info(dt, B, 16, 512, 64, bs, nb)
    assert (info["splits"] == 1) == one_range
    if dtype == "bfloat16":
        assert info["ctas_per_sm"] >= 2
    args = _mla_inputs(gen, B, nb, bs, dt)
    pos = torch.randint(0, S + 4, (B,), generator=gen, device="cuda")  # int64
    if not one_range:
        chunk = -(-(-(-S // MLA_TILE)) // info["splits"]) * MLA_TILE
        edges = _range_edges(chunk, S)
        pos[:len(edges)] = torch.tensor(edges, device="cuda")
    scale = 1.0 / 192 ** 0.5
    out = paged_mla_decode_attention(*args, pos, scale=scale)
    ref = paged_mla_decode_attention_ref(*args, pos, scale=scale)
    # f32: sums in another order (1e-5); bf16: one output rounding (1e-2)
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    # int32 pos, one pos for every row, and an int64 table give the same result
    torch.testing.assert_close(paged_mla_decode_attention(*args, pos.to(torch.int32),
                                                          scale=scale), out, rtol=0, atol=0)
    torch.testing.assert_close(paged_mla_decode_attention(*args[:4], args[4].long(), pos,
                                                          scale=scale), out, rtol=0, atol=0)
    one = paged_mla_decode_attention(*args, int(pos[3]), scale=scale)
    torch.testing.assert_close(one.float(), paged_mla_decode_attention_ref(
        *args, int(pos[3]), scale=scale).float(), rtol=tol, atol=tol)


def test_paged_mla_bf16_refuses_misaligned_queries(gen):
    """bf16 query rows reach shared memory by TMA bulk copies, so they need
    16-byte aligned rows: a q_pe view 4 bytes off raises before any launch."""
    q_lat, q_pe, c_pool, kpe_pool, table = _mla_inputs(gen, 2, 2, 16, torch.bfloat16, H=4, r=32,
                                                       dr=8)
    off = torch.randn(2, 4, 10, generator=gen, device="cuda").to(torch.bfloat16)[..., 2:]
    n0 = paged_mla_decode_attention.launches
    with pytest.raises(ValueError):
        paged_mla_decode_attention(q_lat, off, c_pool, kpe_pool, table, 5, scale=0.1)
    assert paged_mla_decode_attention.launches == n0
    paged_mla_decode_attention(q_lat, q_pe, c_pool, kpe_pool, table, 5, scale=0.1)
    assert paged_mla_decode_attention.launches == n0 + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_mla_merge_order_is_fixed(gen, dtype):
    """The ranges are merged in range order, whichever CTA finishes last:
    two calls on the same operands give the same bits."""
    from repro_torch.kernels.decode_attention.kernel import mla_launch_info  # repro: allow[tier1-deps] — the port under test

    dt = getattr(torch, dtype)
    B, nb = 32, 256
    assert mla_launch_info(dt, B, 16, 512, 64, 16, nb)["splits"] > 4
    args = _mla_inputs(gen, B, nb, 16, dt)
    pos = torch.randint(2048, nb * 16, (B,), generator=gen, device="cuda")
    first = paged_mla_decode_attention(*args, pos, scale=0.07)
    for _ in range(3):
        assert torch.equal(paged_mla_decode_attention(*args, pos, scale=0.07), first)


def test_mla_and_ssd_wrappers_launch_only_their_kernel(gen):
    """On the model's operands (int64 pos, an int32 table; x and dt views of
    (B, S, H, .) storage) a call launches its kernels and nothing else: no
    cast, no copy, no fill; where the MLA key axis is split, the walk and
    the kernel that merges its ranges."""
    dt = torch.bfloat16
    q_lat, q_pe, c_pool, kpe_pool, table = _mla_inputs(gen, 8, 64, 16, dt)
    pos = torch.randint(512, 1024, (8,), generator=gen, device="cuda")  # int64
    x, dts, A, Bm, Cm = _ssd_inputs(gen, 1, 80, 128, 64, 128, dt)

    def calls():
        paged_mla_decode_attention(q_lat, q_pe, c_pool, kpe_pool, table, pos, scale=0.07)
        ssd_chunked(x, dts, A, Bm, Cm)

    calls()  # the first call sizes the merge's cached workspace
    torch.cuda.synchronize()
    n0 = (paged_mla_decode_attention.launches, ssd_chunked.launches)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        calls()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 3, names
    for name, kernel in zip(names, ("mla_bf16_kernel", "mla_combine_kernel", "ssd_bf16_kernel")):
        assert kernel in name, names
    assert (paged_mla_decode_attention.launches, ssd_chunked.launches) == (n0[0] + 1, n0[1] + 1)


def _w(gen, layout, d, V, dt):
    if layout == "embed_T":  # the tied head: embed (V, d) viewed (d, V), contiguous along d
        return (0.05 * torch.randn(V, d, generator=gen, device="cuda")).to(dt).T
    return (0.05 * torch.randn(d, V, generator=gen, device="cuda")).to(dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["d_by_V", "embed_T"])
@pytest.mark.parametrize("B,d", [(1, 136), (8, 1536), (11, 104)])  # 104: a partial stage
def test_ramp_kernel_matches_plain(gen, dtype, layout, B, d):
    dt = getattr(torch, dtype)
    V, vl = 1000, 990  # V not a multiple of the 256-column tile
    h = torch.randn(B, d, generator=gen, device="cuda").to(dt)
    w = _w(gen, layout, d, V, dt)
    thr = torch.rand(B, generator=gen, device="cuda")
    got = ramp_head_exit(h, w, thr, v_limit=vl)
    ref = ramp_head_exit_ref(h, w, thr, vl)
    st = ramp_head_stats(h, w, v_limit=vl)
    for x, y, z in zip(got[:3], ref[:3], st[:3]):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4 * float(y.abs().max()))
        torch.testing.assert_close(x, z, rtol=0, atol=0)  # one kernel, two wrappers
    lg = torch.where(torch.arange(V, device="cuda") < vl, h.float() @ w.float(), -1e30)
    top2 = lg.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3  # labels exact unless a near-tie
    assert torch.equal(got[3][clear], ref[3][clear])
    assert int(got[3].max()) < vl
    unc = 1.0 - 1.0 / ref[1]
    far = (unc - thr).abs() > 1e-6  # exit bits exact unless |unc - thr| is tiny
    assert torch.equal(got[4][far], ref[4][far])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["d_by_V", "embed_T"])
def test_ramp_exit_boundary_is_strict_on_card(gen, dtype, layout):
    """unc = 1 - 1/s formed in f32 from the kernel's own s: thr == unc must
    not exit, the next float up must (the kernel's compare is strict <)."""
    dt = getattr(torch, dtype)
    B, d, V, vl = 8, 1536, 1000, 990
    h = torch.randn(B, d, generator=gen, device="cuda").to(dt)
    w = _w(gen, layout, d, V, dt)
    _, s, _, _ = ramp_head_stats(h, w, v_limit=vl)
    s_host = s.cpu()
    unc = torch.ones_like(s_host) - torch.ones_like(s_host) / s_host  # IEEE f32 on the host
    up = torch.nextafter(unc, torch.full_like(unc, float("inf")))
    at = ramp_head_exit(h, w, unc.cuda(), v_limit=vl)
    above = ramp_head_exit(h, w, up.cuda(), v_limit=vl)
    assert torch.equal(at[1], s) and torch.equal(above[1], s)  # one kernel, deterministic
    assert not at[4].any()
    assert above[4].all()


def _ramp_grid(B, d, V, vl, w):
    """CTAs (= partial records a row) of the bf16 ramp-head launch, from the
    library that sizes its scratch."""
    from repro_torch.kernels.ramp_head.kernel import _lib  # repro: allow[tier1-deps] — the port under test

    return _lib().ramp_head_parts(B, d, V, vl, *w.stride(), 1)


def _check_ramp_exit(got, h, w, thr, vl):
    ref = ramp_head_exit_ref(h, w, thr, vl)
    for x, y in zip(got[:3], ref[:3]):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4 * float(y.abs().max()))
    V = w.shape[1]
    lg = torch.where(torch.arange(V, device="cuda") < vl, h.float() @ w.float(), -1e30)
    top2 = lg.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3  # labels exact unless a near-tie
    assert torch.equal(got[3][clear], ref[3][clear])
    unc = 1.0 - 1.0 / ref[1]
    far = (unc - thr).abs() > 1e-6  # exit bits exact unless |unc - thr| is tiny
    assert torch.equal(got[4][far], ref[4][far])


@pytest.mark.parametrize("layout", ["d_by_V", "embed_T"])
@pytest.mark.parametrize("B", [1, 8, 9, 16, 17, 33])  # row groups of 8, passes of <= 32 rows
@pytest.mark.parametrize("limit", ["none", "edge", "inside", "few"])
def test_ramp_bf16_rows_and_v_limit(gen, layout, B, limit):
    """The bf16 wave against its plain version. V spans several 16-column
    blocks per warp; v_limit: none, on a block edge, inside a block, or so
    small that each CTA has one block (fewer live blocks than SMs). d 136
    is a multiple of neither stage depth (32 and 64)."""
    d, V = 136, 132 * 16 * 8 * 3 + 72  # the last block holds 8 columns
    vl = {"none": V, "edge": V - 72 - 16 * 5, "inside": V - 72 - 13, "few": 1000}[limit]
    h = torch.randn(B, d, generator=gen, device="cuda").bfloat16()
    w = _w(gen, layout, d, V, torch.bfloat16)
    thr = torch.rand(B, generator=gen, device="cuda")
    if limit == "few":
        assert _ramp_grid(B, d, V, vl, w) == -(-vl // 16)  # one live block a CTA
    got = ramp_head_exit(h, w, thr, v_limit=vl)
    _check_ramp_exit(got, h, w, thr, vl)
    assert int(got[3].max()) < vl
    st = ramp_head_stats(h, w, v_limit=vl)
    for x, z in zip(got[:4], st):
        assert torch.equal(x, z)  # one kernel, two wrappers


@pytest.mark.parametrize("layout", ["d_by_V", "embed_T"])
def test_ramp_bf16_argmax_tie_across_ctas_takes_first(gen, layout):
    """A column duplicated far apart, first in the runs of the second and
    the second-to-last CTA (so at the same place in their warps' tiles), is
    every row's max: the merge must return the lower index."""
    B, d, V = 9, 104, 132 * 16 * 8 * 2
    h = torch.rand(B, d, generator=gen, device="cuda").bfloat16()  # positive rows
    w = _w(gen, layout, d, V, torch.bfloat16)
    G = _ramp_grid(B, d, V, V, w)
    assert G >= 4
    n_blk = V // 16  # 16-column blocks, split evenly over the CTAs
    a = (n_blk * 1 // G) * 16 + 5
    b = (n_blk * (G - 2) // G) * 16 + 5
    w[:, a] = 1.0  # (a view of embed for embed_T: the same columns)
    w[:, b] = 1.0
    m, s, t, idx = ramp_head_stats(h, w)
    assert (idx == a).all(), idx.tolist()
    ref = ramp_head_exit_ref(h, w, torch.zeros(B, device="cuda"))
    torch.testing.assert_close(m, ref[0], rtol=1e-4, atol=1e-4 * float(ref[0].abs().max()))
    torch.testing.assert_close(s, ref[1], rtol=1e-4, atol=1e-4)


def test_empty_batch_launches_nothing(gen):
    """A wrapper counts a launch only where its kernel launched: B == 0
    returns empty outputs and leaves every counter as it was."""
    def counts():
        return (decode_attention.launches, paged_decode_attention.launches,
                ramp_head_stats.launches, ramp_head_exit.launches)

    n0 = counts()
    w = torch.randn(64, 300, generator=gen, device="cuda")
    m, s, t, idx = ramp_head_stats(torch.empty(0, 64, device="cuda"), w)
    out = ramp_head_exit(torch.empty(0, 64, device="cuda"), w, torch.empty(0, device="cuda"))
    att = decode_attention(torch.empty(0, 4, 64, device="cuda"),
                           torch.empty(0, 2, 8, 64, device="cuda"),
                           torch.empty(0, 2, 8, 64, device="cuda"), 3)
    pool = torch.zeros(3, 16, 2, 64, device="cuda")
    patt = paged_decode_attention(torch.empty(0, 4, 64, device="cuda"), pool, pool,
                                  torch.zeros(0, 2, dtype=torch.int32, device="cuda"), 3)
    assert m.shape == idx.shape == out[4].shape == (0,) and att.shape == patt.shape == (0, 4, 64)
    assert counts() == n0
    ramp_head_stats(torch.randn(2, 64, generator=gen, device="cuda"), w)
    paged_decode_attention(torch.randn(1, 4, 64, generator=gen, device="cuda"), pool, pool,
                           torch.ones(1, 2, dtype=torch.int32, device="cuda"), 3)
    assert counts() == (n0[0], n0[1] + 1, n0[2] + 1, n0[3])


def test_tiny_model_kernels_on_matches_plain_path(gen):
    """Tiny qwen2 with hd=64 (a width the decode kernel takes), f32: prefill
    and two decode steps with the kernels on vs the dense path."""
    cfg = get_tiny("qwen2-1.5b").replace(head_dim=64)
    on = build_model(cfg.replace(decode_attn="kernel", pallas_head="kernel"))
    off = build_model(cfg)
    params = on.init(0, device="cuda")
    toks = torch.randint(1, cfg.vocab_size, (4, 9), generator=gen, device="cuda")
    act = list(range(len(on.sites)))
    thr = torch.full((len(act),), 0.99, device="cuda")
    (c_on, o_on), (c_off, o_off) = (m.prefill(params, toks, cache_len=16, active_sites=act)
                                    for m in (on, off))
    pos = torch.tensor([9, 11, 10, 9], device="cuda")
    for _ in range(2):
        for a, b in ((o_on["final"], o_off["final"]), (o_on["ramps"], o_off["ramps"])):
            assert torch.equal(a["label"], b["label"])
            torch.testing.assert_close(a["maxprob"], b["maxprob"], rtol=1e-4, atol=1e-6)
        tok = o_off["final"]["label"].reshape(-1, 1).long()
        _, o_on = on.decode(params, c_on, tok, pos, active_sites=act, exit_thresholds=thr)
        _, o_off = off.decode(params, c_off, tok, pos, active_sites=act, exit_thresholds=thr)
        assert torch.equal(o_on["ramps"]["exit"], o_off["ramps"]["exit"])
        pos = pos + 1
    for a, b in zip(c_on["blocks"][0].values(), c_off["blocks"][0].values()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_tiny_deepseek_paged_kernel_matches_plain_path(gen):
    """Tiny deepseek (MLA + MoE), f32, absorbed MLA on a latent pool: two
    decode steps through the paged MLA kernel vs its plain version."""
    cfg = get_tiny("deepseek-v2-lite-16b").replace(mla_absorbed=True, pallas_head="kernel")
    on = build_model(cfg.replace(decode_attn="paged-kernel"))
    off = build_model(cfg.replace(decode_attn="paged"))
    params = on.init(0, device="cuda")
    B, nb, bs = 4, 3, 8
    c_on = on.init_paged_cache(B * nb + 1, bs, device="cuda")
    for leaf in (c_on["prefix"][0]["c"], c_on["blocks"][0]["c"]):
        leaf.normal_(generator=gen)
    c_off = {k: ([{kk: t.clone() for kk, t in d.items()} for d in v]) for k, v in c_on.items()}
    table = (torch.randperm(B * nb, generator=gen, device="cuda") + 1).reshape(B, nb)
    tok = torch.randint(1, cfg.vocab_size, (B, 1), generator=gen, device="cuda")
    pos = torch.tensor([3, 9, 16, 20], device="cuda")
    n0 = paged_mla_decode_attention.launches
    for _ in range(2):
        _, o_on = on.decode(params, c_on, tok, pos, block_tables=table)
        _, o_off = off.decode(params, c_off, tok, pos, block_tables=table)
        assert torch.equal(o_on["final"]["label"], o_off["final"]["label"])
        torch.testing.assert_close(o_on["final"]["maxprob"], o_off["final"]["maxprob"],
                                   rtol=1e-4, atol=1e-6)
        tok, pos = o_off["final"]["label"].reshape(-1, 1).long(), pos + 1
    assert paged_mla_decode_attention.launches - n0 == 2 * cfg.n_layers


def _strided(gen, shape, dt):
    """A (B, S, H, w) tensor viewed (B, H, S, w), as the models hand over
    their projections."""
    B, H, S, w = shape
    return torch.randn(B, S, H, w, generator=gen, device="cuda").to(dt).transpose(1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,Sq,Sk,hd,causal,window", [
    (1, 12, 2, 128, 160, 128, True, None),  # qwen2's served prefill (bf16: 32-query CTAs)
    (2, 4, 4, 120, 120, 64, True, None),    # ragged tails on both axes
    (1, 8, 2, 77, 200, 128, False, None),   # no mask, Sq != Sk
    (2, 4, 1, 100, 100, 32, True, 16),      # causal sliding window
    (1, 2, 2, 65, 65, 16, False, 8),        # window alone
    (1, 4, 2, 50, 30, 64, False, None),     # Sk under one key tile, Sq != Sk
    (2, 4, 2, 65, 65, 128, True, None),     # Sk = 64 + 1
    (1, 6, 3, 200, 129, 32, True, None),    # Sk = 128 + 1; queries past Sk
    (3, 4, 1, 1, 129, 16, False, None),     # one query
    (1, 2, 1, 1, 70, 128, True, None),      # one query, causal: key 0 alone
    (1, 4, 2, 300, 300, 64, True, 100),     # windows across the two-stage K/V ring
    (1, 2, 2, 256, 256, 128, False, 70),    # window alone across the ring
    (1, 4, 4, 90, 90, 40, True, None),      # hd 40 (bf16: zero-padded to 64)
    (2, 3, 1, 33, 47, 24, False, None),     # hd 24 (bf16: zero-padded to 32)
    (2, 16, 4, 300, 300, 64, True, None),   # 160 CTAs of 64 queries (bf16: 4 warps)
    (1, 16, 2, 1100, 1100, 128, True, None),  # 18 key tiles, ragged
    (2, 16, 16, 600, 600, 16, True, 200),   # hd 16, windowed, many CTAs
])
def test_flash_kernel_matches_plain(gen, dtype, B, H, KH, Sq, Sk, hd, causal, window):
    dt = getattr(torch, dtype)
    q = _strided(gen, (B, H, Sq, hd), dt)
    k = _strided(gen, (B, KH, Sk, hd), dt)
    v = _strided(gen, (B, KH, Sk, hd), dt)
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == n0 + 1 and out.shape == ref.shape
    # f32: sums in another order (1e-5); bf16: one output rounding (1e-2)
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sk", [32, 33, 100, 512])  # 32: BERT's served stream; 512 its max
def test_flash_noncausal_mha_hd64_matches_plain(gen, dtype, Sk):
    """BERT's encoder attention: no mask, H = KH = 12, hd 64, Sq = Sk (under
    one key tile, one past it, ragged, many tiles), q/k/v the (B, H, S, 64)
    views of (B, S, 768) projections that the encoder hands over."""
    dt = getattr(torch, dtype)
    B, H, hd = 8, 12, 64
    q, k, v = (torch.randn(B, Sk, H * hd, generator=gen, device="cuda").to(dt)
               .reshape(B, Sk, H, hd).transpose(1, 2) for _ in range(3))
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, causal=False)
    ref = attention_ref(q, k, v, causal=False)
    assert flash_attention.launches == n0 + 1
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_flash_bf16_refuses_misaligned_rows(gen):
    """bf16 q/k/v arrive by 16-byte copies: a base or a row stride that is
    not a multiple of 16 bytes raises, and launches nothing."""
    x = torch.randn(1, 2, 64, 72, generator=gen, device="cuda").bfloat16()
    good = x[..., :64]
    n0 = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(x[..., 4:68], good, good)  # base 8 bytes off
    y = torch.randn(1, 2, 64, 68, generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError):
        flash_attention(good, y[..., :64], good)  # rows 136 bytes apart
    assert flash_attention.launches == n0
    flash_attention(good, good, good)
    assert flash_attention.launches == n0 + 1


def _ssd_inputs(gen, B, H, S, hp, N, dt):
    x = _strided(gen, (B, H, S, hp), dt)
    dts = torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device="cuda") - 2)
    A = -torch.exp(torch.rand(H, generator=gen, device="cuda") * 2.7726)  # -[1, 16)
    Bm = torch.randn(B, S, N, generator=gen, device="cuda").to(dt)
    Cm = torch.randn(B, S, N, generator=gen, device="cuda").to(dt)
    return x, dts.transpose(1, 2), A, Bm, Cm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S,hp,N", [
    (1, 80, 128, 64, 128),  # Mamba2-2.7B's served prefill: two chunks
    (1, 80, 120, 64, 128),  # a ragged last chunk
    (2, 4, 200, 32, 16),    # tiny widths, four chunks, the last ragged
    (2, 3, 1, 48, 100),     # one step
    (2, 6, 1000, 48, 100),  # 16 chunks, the last ragged; a half slice, N not a multiple of 8
    (2, 5, 1000, 64, 128),  # 16 chunks at Mamba2's widths, the state carried 15 times
])
def test_ssd_kernel_matches_plain(gen, dtype, B, H, S, hp, N):
    """Against the plain version at the reference's chunking (64 where it
    divides S, else one chunk of S): y and the final state, f32."""
    x, dts, A, Bm, Cm = _ssd_inputs(gen, B, H, S, hp, N, getattr(torch, dtype))
    n0 = ssd_chunked.launches
    y, st = ssd(x, dts, A, Bm, Cm)
    y_ref, st_ref = ssd(x, dts, A, Bm, Cm, use_kernel=False)
    assert ssd_chunked.launches == n0 + 1
    assert y.shape == y_ref.shape == (B, H, S, hp) and st.shape == st_ref.shape == (B, H, hp, N)
    # f32 internals in both, the sums in another order and grouping: 1e-4
    # relative to the largest magnitude
    for a, r in ((y, y_ref), (st, st_ref)):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


def test_ssd_kernel_refuses_what_it_cannot_take(gen):
    x, dts, A, Bm, Cm = _ssd_inputs(gen, 1, 2, 8, 64, 128, torch.float32)
    with pytest.raises(ValueError):
        ssd_chunked(x, dts, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError):
        ssd_chunked(x, dts, A, Bm.bfloat16(), Cm)
    with pytest.raises(ValueError):
        ssd_chunked(x[..., :16].repeat(1, 1, 1, 5), dts, A, Bm, Cm)  # hp 80 > 64


def test_tiny_mamba_ssd_kernel_matches_plain_path(gen):
    """Tiny mamba2, f32: prefill (two chunks and a ragged tail) and two
    decode steps with the SSD kernel vs the plain scan; the kernel runs once
    a layer a prefill."""
    cfg = get_tiny("mamba2-2.7b").replace(pallas_head="kernel")
    on, off = build_model(cfg, ssd_impl="kernel"), build_model(cfg, ssd_impl="ref")
    params = on.init(0, device="cuda")
    toks = torch.randint(1, cfg.vocab_size, (3, 150), generator=gen, device="cuda")
    act = list(range(len(on.sites)))
    n0 = ssd_chunked.launches
    (c_on, o_on), (c_off, o_off) = (m.prefill(params, toks, active_sites=act) for m in (on, off))
    assert ssd_chunked.launches == n0 + cfg.n_layers
    pos = torch.full((3,), 150, device="cuda")
    for _ in range(2):
        for a, b in ((o_on["final"], o_off["final"]), (o_on["ramps"], o_off["ramps"])):
            assert torch.equal(a["label"], b["label"])
            torch.testing.assert_close(a["maxprob"], b["maxprob"], rtol=1e-4, atol=1e-6)
        tok = o_off["final"]["label"].reshape(-1, 1).long()
        _, o_on = on.decode(params, c_on, tok, pos, active_sites=act)
        _, o_off = off.decode(params, c_off, tok, pos, active_sites=act)
        pos = pos + 1
    for a, b in zip(c_on["blocks"][0].values(), c_off["blocks"][0].values()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_tiny_qwen_flash_prefill_matches_sdpa(gen):
    """Tiny qwen2 (hd 16), f32: a prefill into a longer cache with
    prefill_attn='kernel' vs 'sdpa'; the kernel runs once a layer."""
    cfg = get_tiny("qwen2-1.5b").replace(pallas_head="kernel")
    on, off = build_model(cfg, prefill_attn="kernel"), build_model(cfg)
    params = on.init(0, device="cuda")
    toks = torch.randint(1, cfg.vocab_size, (4, 70), generator=gen, device="cuda")
    act = list(range(len(on.sites)))
    n0 = flash_attention.launches
    (c_on, o_on), (c_off, o_off) = (m.prefill(params, toks, cache_len=90, active_sites=act)
                                    for m in (on, off))
    assert flash_attention.launches == n0 + cfg.n_layers
    for a, b in ((o_on["final"], o_off["final"]), (o_on["ramps"], o_off["ramps"])):
        assert torch.equal(a["label"], b["label"])
        torch.testing.assert_close(a["maxprob"], b["maxprob"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gpt2-medium", "deepseek-v2-lite-16b",
                                  "mamba2-2.7b"])
def test_window_graphs_match_eager_runner(gen, arch, paged, dtype):
    """One schedule of sync windows through a runner on CUDA graphs and an
    eager one: records, host state, launch counts and every cache leaf
    equal bit for bit; each key runs eager once, is captured at its second
    window (its kernel nodes checked against its launches) and replays
    after."""
    cfg = get_tiny(arch).replace(dtype=dtype, pallas_head="kernel",
                                 decode_attn="paged-kernel" if paged else "kernel")
    if cfg.mla:
        cfg = cfg.replace(mla_absorbed=True)
    elif not cfg.ssm:
        cfg = cfg.replace(head_dim=64)  # a width the decode kernel takes
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    prompts = np.random.default_rng(0).integers(1, cfg.vocab_size, (8, 9))
    kw = dict(max_new_tokens=24, max_slots=2, n_slots=8, kv_block_size=4)
    runs = {}
    for name, graphs in (("eager", False), ("graphed", None)):
        r = DecodeRunner(model, params, prompts, graphs=graphs, **kw)
        assert (r.graphs is None) == (graphs is False)
        for s in range(8):
            r.start(s, s)
        fns = counted_wrappers()
        for f in fns.values():
            f.launches = 0
        thr, thr2 = np.array([0.5, 0.9], np.float32), np.array([0.2], np.float32)
        recs = [r.step_multi(list(range(8)), [0, 1], 4, thr) for _ in range(3)]
        recs += [r.step_multi([0, 1, 2, 3], [1], 2, thr2) for _ in range(2)]
        recs += [r.step_multi(list(range(8)), [0, 1], 4, np.ones(2, np.float32))]
        torch.cuda.synchronize()
        runs[name] = (r, recs, {k: f.launches for k, f in fns.items()})
    (e, e_recs, e_n), (g, g_recs, g_n) = runs["eager"], runs["graphed"]
    for a, b in zip(e_recs, g_recs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert g_recs[-1][2].shape[0] == 1  # every row exits at once: the gated steps run
    assert e_n == g_n and e.decode_steps == g.decode_steps
    assert g_n["ramp_head_exit"] > 0
    assert (g.graphs.eagers, g.graphs.captures, g.graphs.replays) == (2, 2, 2)
    assert (e._pos.tolist(), e._tok.tolist()) == (g._pos.tolist(), g._tok.tolist())
    for a, b in zip(tree_leaves(e._cache), tree_leaves(g._cache)):
        assert torch.equal(a, b)


def test_window_graph_keeps_its_decode_workspace(gen):
    """A graph captured at a small key split keeps the workspace it writes:
    a larger eager call on the capture stream grows the cached workspace,
    fresh allocations there may take memory it would have given up, and
    the replay still equals the eager result. Growth inside a capture
    raises."""
    dt, H, KH, hd = torch.bfloat16, 12, 2, 128

    def case(B, S):
        q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, S, KH, hd, generator=gen, device="cuda").to(dt).transpose(1, 2)
        v = torch.randn(B, S, KH, hd, generator=gen, device="cuda").to(dt).transpose(1, 2)
        return q, k, v, torch.randint(S // 2, S, (B,), generator=gen, device="cuda")

    q, k, v, pos = case(2, 1024)
    want = decode_attention(q, k, v, pos)
    graphs = WindowGraphs(q.device, capture=True)
    host = {"pos": pos.cpu().numpy()}

    def body(static):
        return (decode_attention(q, k, v, static["pos"]),)

    first = graphs.run("small", host, body)[0]  # eager: sizes the capture stream's workspace
    second = graphs.run("small", host, body)[0].clone()  # captured, then replayed
    with torch.cuda.stream(graphs._stream):
        decode_attention(*case(32, 4096))  # grows the capture stream's workspace
        junk = [torch.full((1 << 20,), -1, dtype=torch.int32, device="cuda") for _ in range(8)]
    again = graphs.run("small", host, body)[0]
    torch.cuda.synchronize()
    assert (graphs.eagers, graphs.captures, graphs.replays) == (1, 1, 1) and junk
    assert graphs.windows["small"].nodes["decode_attention"] == 1
    for got in (first, second, again):
        assert torch.equal(got, want)
    s, g = torch.cuda.Stream(), torch.cuda.CUDAGraph()
    with torch.cuda.stream(s):
        g.capture_begin()
        try:
            with pytest.raises(RuntimeError, match="capture"):
                decode_attention(q, k, v, pos)  # a new stream: nothing sized yet
        finally:
            g.capture_end()



def _clear(logits, tol=1e-3):
    """Where the top-2 logits are more than ``tol`` apart (labels exact
    there; a nearer pair may order either way)."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return ((top2[..., 0] - top2[..., 1]) > tol).numpy()


@pytest.mark.parametrize("arch", ["resnet18", "resnet50", "bert-base"])
def test_classifier_runner_on_card_matches_cpu_forward(gen, arch):
    """``ClassifierRunner`` on the card (tiny, f32; BERT's attention through
    the flash kernel, once a layer a batch; convolutions with TF32 off)
    against the same model's forward on the CPU: labels equal except
    near-ties, uncertainty within 1e-4."""
    from repro_torch.data import make_image_stream, make_token_stream  # repro: allow[tier1-deps] — the port under test
    from repro_torch.models.common import tree_map  # repro: allow[tier1-deps] — the port under test
    from repro_torch.serving import ClassifierRunner  # repro: allow[tier1-deps] — the port under test

    torch.backends.cudnn.allow_tf32 = False
    cfg = get_tiny(arch)
    model = build_model(cfg) if cfg.family == "resnet" else build_model(cfg, prefill_attn="kernel")
    params = model.init(0, device="cpu")
    if cfg.family == "resnet":
        data = make_image_stream(16, img_size=cfg.img_size, n_classes=cfg.n_classes, seed=1).data
    else:
        data = make_token_stream(16, seq_len=24, vocab=cfg.vocab_size, n_classes=2, seed=1).data
    runner = ClassifierRunner(model, tree_map(lambda t: t.cuda(), params), data, max_slots=2)
    act = [0] if len(model.sites) == 1 else [len(model.sites) - 1, 0]
    calls = ((np.arange(8), act), (np.array([5, 2, 9]), []), (np.arange(16), act))
    n0 = flash_attention.launches
    for items, a in calls:
        labels, unc, final = runner.infer(items, a)
        ref = model.forward(params, torch.from_numpy(data[items]), active_sites=sorted(a) or None)
        ok = _clear(ref["final_logits"])
        np.testing.assert_array_equal(final[ok], ref["final"]["label"].numpy()[ok])
        if a:
            ok = _clear(ref["ramp_logits"])
            np.testing.assert_array_equal(labels[ok], ref["ramps"]["label"].numpy()[ok])
            np.testing.assert_allclose(unc, 1.0 - ref["ramps"]["maxprob"].numpy(),
                                       rtol=1e-4, atol=1e-5)
    expect = 0 if cfg.family == "resnet" else cfg.n_layers * len(calls)
    assert flash_attention.launches - n0 == expect


# -- training (the loss reaches no kernel; the dispatchers refuse autograd) -----


def test_ramps_only_step_on_card_matches_cpu(gen):
    """One ramps_only step of tiny qwen2 (f32, TF32 off) on the card and on
    the CPU from the same state: loss, grad norm and every leaf within
    1e-5 (the products sum in other orders); the backbone bit-identical."""
    from repro_torch.data import TokenPipeline  # repro: allow[tier1-deps] — the port under test
    from repro_torch.models.common import tree_map  # repro: allow[tier1-deps] — the port under test
    from repro_torch.training import TrainConfig, init_state, make_train_step  # repro: allow[tier1-deps] — the port under test

    cfg = get_tiny("qwen2-1.5b")
    model = build_model(cfg)
    tcfg = TrainConfig(steps=4, lr=1e-2, warmup=1, train_mode="ramps_only")
    step_fn, oc = make_train_step(model, tcfg)
    cpu = init_state(model, 0, oc, device="cpu")
    card = tree_map(lambda t: t.cuda(), cpu)
    before = tree_map(torch.clone, cpu)
    pipe = TokenPipeline(cfg.vocab_size, 32, 4, seed=0)
    outs = []
    for state in (cpu, card):
        for s in range(2):  # the second step has a non-zero lr scale
            state, out = step_fn(state, pipe.batch_at(s))
        outs.append((state, out))
    (sc, oc_), (sg, og) = outs
    for k in ("loss", "grad_norm", "ramp_loss"):
        torch.testing.assert_close(og[k].cpu(), oc_[k], rtol=1e-5, atol=1e-6)
    for a, b in zip(tree_leaves(sg), tree_leaves(sc)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    for key in ("tok", "blocks", "final_norm"):
        for a, b in zip(tree_leaves(sg["params"][key]), tree_leaves(before["params"][key])):
            assert torch.equal(a.cpu(), b)


def test_kernel_dispatchers_raise_under_autograd_on_card(gen):
    from repro_torch.kernels.decode_attention import (  # repro: allow[tier1-deps] — the port under test
        attend_decode,
        attend_decode_paged,
        attend_decode_paged_mla,
    )
    from repro_torch.kernels.flash_attention import attention  # repro: allow[tier1-deps] — the port under test
    from repro_torch.kernels.ramp_head import ramp_confidence, ramp_exit_decision  # repro: allow[tier1-deps] — the port under test

    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k = r(2, 4, 64), r(2, 2, 32, 64)
    pos = torch.tensor([3, 5], device="cuda")
    pool = r(5, 16, 2, 64)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device="cuda")
    qf = r(1, 2, 32, 64)
    h, w = r(3, 64), r(64, 256)
    calls = {
        "attend_decode": (lambda t: attend_decode(t, k, k, pos), q),
        "attend_decode_paged": (lambda t: attend_decode_paged(t, pool, pool, table, pos), q),
        "attend_decode_paged_mla": (
            lambda t: attend_decode_paged_mla(t, r(2, 16, 64), r(5, 16, 512), r(5, 16, 64),
                                              table, pos, scale=0.1), r(2, 16, 512)),
        "attention": (lambda t: attention(t, qf, qf), qf.clone()),
        "ramp_confidence": (lambda t: ramp_confidence(t, w), h),
        "ramp_exit_decision": (
            lambda t: ramp_exit_decision(t, w, torch.zeros(3, device="cuda")), h),
    }
    n0 = {name: f.launches for name, f in counted_wrappers().items()}
    for name, (fn, arg) in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            fn(arg.clone().requires_grad_(True))
    x = torch.randn(1, 2, 64, 32, generator=gen, device="cuda", requires_grad=True)
    dt = torch.rand(1, 2, 64, generator=gen, device="cuda")
    A = -torch.rand(2, generator=gen, device="cuda")
    Bm = torch.randn(1, 64, 16, generator=gen, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        ssd(x, dt, A, Bm, Bm)
    # a refused call launches nothing
    assert {name: f.launches for name, f in counted_wrappers().items()} == n0


def test_bf16_checkpoint_round_trip_on_card(gen, tmp_path):
    """bf16 and f32 leaves of a card state saved (sync and async) and
    restored onto the card bit for bit."""
    from repro_torch.checkpoint import CheckpointManager  # repro: allow[tier1-deps] — the port under test

    state = {"params": {"w": torch.randn(64, 48, generator=gen, device="cuda")
                        .to(torch.bfloat16),
                        "ramps": [torch.randn(3, 8, generator=gen, device="cuda")]},
             "step": torch.tensor(5, dtype=torch.int32, device="cuda")}
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state, step=5)
    mgr.save_async(state, step=6)
    mgr.wait()
    for s in (5, 6):
        back = mgr.restore(s, device="cuda")
        for a, b in zip(tree_leaves(back), tree_leaves(state)):
            assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b)
