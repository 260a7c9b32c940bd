"""The port's SSD chunk scan against the JAX package's, at tiny shapes: the
plain ``ssd`` (``repro_torch.kernels.ssd``) against the Pallas
``ssd_chunked`` in interpret mode, ``ssd_chunked_ref`` and ``mamba.ssd_ref``,
including a ragged tail (the reference chunks it as one chunk of S; the CUDA
kernel as chunks of 64 whose zero-padded steps leave the state unchanged,
shown here on the plain version) and a non-zero ``init_state``.

Tolerance rule: one scan within 1e-5 (f32), relative to the output's
largest magnitude where the sums are regrouped by another chunking."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.ssd import ssd_chunked as pallas_ssd  # noqa: E402
from repro.kernels.ssd import ssd_chunked_ref as jax_chunked_ref  # noqa: E402
from repro.models import mamba as RM  # noqa: E402

from repro_torch.kernels.ssd import ssd, ssd_chunked, ssd_chunked_ref  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.models import mamba as TM  # noqa: E402  # repro: allow[tier1-deps] — the port under test

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(B, H, S, hp, N, seed, G=1):
    """Kernel layout: x (B,H,S,hp), dt (B,H,S) post-softplus, A (H,) < 0,
    Bm/Cm (B,S,N) (with G > 1: (B,S,G,N), the model layout's groups)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, S, hp)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H, S)) - 2)).astype(np.float32)
    A = -np.exp(rng.uniform(0, np.log(16), H)).astype(np.float32)
    shp = (B, S, N) if G == 1 else (B, S, G, N)
    return (x, dt, A, rng.standard_normal(shp).astype(np.float32),
            rng.standard_normal(shp).astype(np.float32))


def _close(a, b, tol=1e-5):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=tol, atol=tol * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("T", [1, 5, 16])
def test_segsum_matches_reference(T):
    a = np.random.default_rng(T).standard_normal((2, 3, T)).astype(np.float32)
    np.testing.assert_allclose(TM.segsum(_t(a)).numpy(), np.asarray(RM.segsum(jnp.asarray(a))),
                               **TOL)


# (B, H, S, hp, N, G, chunk): one chunk, several, two groups of heads
SSD_SHAPES = [(2, 4, 16, 8, 8, 1, 16), (1, 4, 48, 16, 8, 1, 16), (2, 4, 32, 8, 4, 2, 8)]


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("init", [False, True])
def test_ssd_ref_matches_reference(shape, init):
    """``mamba.ssd_ref`` in the model layout (b, s, h, p), with and without a
    non-zero state entering the first chunk."""
    B, H, S, hp, N, G, ck = shape
    x, dt, A, Bm, Cm = _inputs(B, H, S, hp, N, sum(shape), G)
    if G == 1:
        Bm, Cm = Bm[:, :, None], Cm[:, :, None]
    xs, dts = x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1)
    st0 = (np.random.default_rng(9).standard_normal((B, H, hp, N)).astype(np.float32)
           if init else None)
    y_r, f_r = RM.ssd_ref(*(jnp.asarray(a) for a in (xs, dts, A, Bm, Cm)), chunk=ck,
                          init_state=None if st0 is None else jnp.asarray(st0))
    y_t, f_t = TM.ssd_ref(*(_t(a) for a in (xs, dts, A, Bm, Cm)), chunk=ck,
                          init_state=None if st0 is None else _t(st0))
    _close(y_t.numpy(), y_r)
    _close(f_t.numpy(), f_r)


@pytest.mark.parametrize("shape", [(1, 2, 32, 8, 8, 16), (2, 2, 16, 8, 16, 16)])
def test_plain_ssd_matches_pallas_interpret_and_refs(shape):
    """The port's dispatcher on CPU tensors (the plain version) against the
    Pallas kernel in interpret mode, the JAX ``ssd_chunked_ref`` and the
    port's ``ssd_chunked_ref``, in the kernel layout."""
    B, H, S, hp, N, ck = shape
    args = _inputs(B, H, S, hp, N, 3 * S)
    y_p, f_p = pallas_ssd(*(jnp.asarray(a) for a in args), chunk=ck, interpret=True)
    y_j, f_j = jax_chunked_ref(*(jnp.asarray(a) for a in args), chunk=ck)
    y_t, f_t = ssd(*(_t(a) for a in args), chunk=ck)
    y_c, f_c = ssd_chunked_ref(*(_t(a) for a in args), chunk=ck)
    assert y_t.dtype == f_t.dtype == torch.float32
    assert y_t.shape == (B, H, S, hp) and f_t.shape == (B, H, hp, N)
    for y_ref, f_ref in ((y_p, f_p), (y_j, f_j)):
        _close(y_t.numpy(), y_ref)
        _close(f_t.numpy(), f_ref)
    np.testing.assert_array_equal(y_c.numpy(), y_t.numpy())
    np.testing.assert_array_equal(f_c.numpy(), f_t.numpy())


@pytest.mark.parametrize("S,ck", [(40, 16), (120, 64), (7, 64)])
def test_ragged_tail(S, ck):
    """S not a multiple of the chunk: the plain dispatcher takes one chunk of
    S, as the reference's ``mamba_apply`` does; the CUDA kernel's scheme,
    steps with x = dt = B = C = 0 up to a whole chunk, gives the same y on
    the real steps and the same final state."""
    B, H, hp, N = 1, 3, 8, 8
    x, dt, A, Bm, Cm = _inputs(B, H, S, hp, N, S)
    y_t, f_t = ssd(*(_t(a) for a in (x, dt, A, Bm, Cm)), chunk=ck)
    xs, dts = x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1)
    y_r, f_r = RM.ssd_ref(jnp.asarray(xs), jnp.asarray(dts), jnp.asarray(A),
                          jnp.asarray(Bm[:, :, None]), jnp.asarray(Cm[:, :, None]), chunk=S)
    _close(y_t.numpy(), np.asarray(y_r).transpose(0, 2, 1, 3))
    _close(f_t.numpy(), f_r)
    Sp = -(-S // ck) * ck

    def pad(a, ax):
        w = [(0, 0)] * a.ndim
        w[ax] = (0, Sp - S)
        return np.pad(a, w)

    y_p, f_p = ssd_chunked_ref(_t(pad(x, 2)), _t(pad(dt, 2)), _t(A), _t(pad(Bm, 1)),
                               _t(pad(Cm, 1)), chunk=ck)
    _close(y_p.numpy()[:, :, :S], y_t.numpy())
    _close(f_p.numpy(), f_t.numpy())


@pytest.mark.parametrize("hp", [1, 8, 31, 32, 33, 48, 64])
def test_ssd_slices_cover_the_head_dim(hp):
    """The CUDA kernel's grid (H, B, ssd_slices(hp)) is a pure function of
    static shapes: whole SSD_SLICE-column slices, the last not empty, and at
    Mamba2-2.7B's widths (80 heads of 64, batch 1) at least one wave of 132
    SMs."""
    from repro_torch.kernels.ssd.kernel import SSD_SLICE, ssd_slices  # repro: allow[tier1-deps] — the port under test

    s = ssd_slices(hp)
    assert s >= 1 and (s - 1) * SSD_SLICE < hp <= s * SSD_SLICE
    assert ssd_slices(hp) == s
    assert 1 * 80 * ssd_slices(64) >= 132


def _bf(t):
    return t.to(torch.bfloat16).float()


def _hi_lo(t, lo=True):
    """An f32 operand as the kernel feeds it to the tensor cores: a bf16 hi
    part and, with ``lo``, the bf16 rounding of what hi leaves."""
    hi = _bf(t)
    return (hi, _bf(t - hi)) if lo else (hi,)


def _bf16_scheme(x, dt, A, Bm, Cm, lo=True, CK=64):
    """The CUDA bf16 kernel's arithmetic in plain torch: x, B and C are exact
    bf16 operands, every f32 factor is folded into the other operand and
    split into bf16 hi + lo parts, each a product of its own (bf16 products
    are exact in f32), sums in f32; chunks of CK with a zero-padded tail.
    Kernel layout in and out."""
    Bb, H, S, hp = x.shape
    Sp = -(-S // CK) * CK
    pad = Sp - S
    x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    dt = torch.nn.functional.pad(dt, (0, pad))
    Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
    Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    a2 = dt * A[None, :, None] * 1.4426950408889634  # cum in log2 units
    stT = torch.zeros(Bb, H, Bm.shape[-1], hp)  # state^T [n][p]
    y = torch.zeros(Bb, H, Sp, hp)
    tril = torch.tril(torch.ones(CK, CK, dtype=torch.bool))
    for c in range(Sp // CK):
        sl = slice(c * CK, (c + 1) * CK)
        xc, dc, Bc, Cc = x[:, :, sl], dt[:, :, sl], Bm[:, None, sl], Cm[:, None, sl]
        cum2 = torch.cumsum(a2[:, :, sl], -1)
        G = Cc @ Bc.transpose(-1, -2)  # exact products, f32 sums
        decay = torch.exp2(torch.where(tril, cum2[..., :, None] - cum2[..., None, :], -math.inf))
        yc = sum(Cc @ part for part in _hi_lo(stT, lo)) * torch.exp2(cum2)[..., None]
        yc = yc + sum(part @ xc for part in _hi_lo(G * decay * dc[..., None, :], lo))
        y[:, :, sl] = yc
        fw = torch.exp2(cum2[..., -1:] - cum2) * dc
        stT = stT * torch.exp2(cum2[..., -1])[..., None, None] + sum(
            part.transpose(-1, -2) @ xc for part in _hi_lo(Bc * fw[..., None], lo))
    return y[:, :, :S], stT.transpose(-1, -2)


@pytest.mark.parametrize("S", [256, 200])
def test_bf16_kernel_precision_scheme_holds_1e4(S):
    """The bf16 kernel's precision scheme, emulated in plain torch, at
    Mamba2's widths (hp 64, N 128; a few heads; four chunks, or a ragged
    200): within 1e-4 of the largest magnitude of the JAX package's
    ``ssd_chunked_ref`` on the same bf16 x, B and C (the tolerance of the
    card tests), and only with the lo parts: bf16 alone misses it."""
    B, H, hp, N = 1, 3, 64, 128
    x, dt, A, Bm, Cm = _inputs(B, H, S, hp, N, S)
    x, Bm, Cm = (np.asarray(_bf(_t(a))) for a in (x, Bm, Cm))  # bf16 operands, exact
    y_r, f_r = jax_chunked_ref(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                               chunk=64 if S % 64 == 0 else S)
    y_r, f_r = _t(y_r), _t(f_r)
    for lo in (True, False):
        y, f = _bf16_scheme(*(_t(a) for a in (x, dt, A, Bm, Cm)), lo=lo)
        ok = all(torch.allclose(a, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))
                 for a, r in ((y, y_r), (f, f_r)))
        assert ok == lo, (lo, [float((a - r).abs().max() / r.abs().max())
                               for a, r in ((y, y_r), (f, f_r))])


def test_kernel_wrapper_never_takes_cpu_tensors():
    """The CUDA wrapper raises on CPU tensors (the dispatcher, not the
    wrapper, picks the plain version); meta runs the kernel's contract;
    other devices raise in the dispatcher."""
    from test_torch_kernels import other_device  # repro: allow[tier1-deps] — the shared stand-in for a device with no path

    args = [_t(a) for a in _inputs(1, 2, 8, 8, 8, 0)]
    with pytest.raises(ValueError):
        ssd_chunked(*args)
    with pytest.raises(ValueError):
        ssd(*[other_device(a) for a in args])
    assert all(t.is_meta for t in ssd(*[a.to("meta") for a in args]))
    before = ssd_chunked.launches
    ssd(*args, use_kernel=True)  # CPU: the plain version, no launch counted
    assert ssd_chunked.launches == before
