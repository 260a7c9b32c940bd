"""The port's meta-device support audit against the reference's committed
support matrix, and the kernels' meta contracts: the small configs here
(the paper's four and five of the reference's architectures), the large
ones in ``test_torch_audit_large.py``. Every config is traced at its full
published width and depth on the ``meta`` device with the kernel switches
on, so every kernel's contract meets every full-width shape."""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.analysis import abstract as AB  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.kernels import KernelShapeError  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.decode_attention import kernel as DA  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.decode_attention import ops as DO  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    decode_attention_ref,
    paged_decode_attention_ref,
    paged_mla_decode_attention_ref,
)
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.ramp_head import kernel as RH  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.ramp_head.ops import ramp_confidence, ramp_exit_decision  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.ramp_head.ref import ramp_head_exit_ref, ramp_head_stats_ref  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.ssd import kernel as SK  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.ssd.ops import ssd  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.ssd.ref import ssd_chunked_ref  # noqa: E402  # repro: allow[tier1-deps] — the port under test

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = json.loads((ROOT / "support_matrix.json").read_text())
PORT = json.loads((ROOT / "src" / "repro_torch" / "analysis" / "support_matrix.json").read_text())

# the cells where the port's matrix differs from the reference's, and why:
# the enc-dec decoder's decode_kernel is a deliberate difference (ROADMAP
# Queue 3 item 1); none further (decode_sharded is decided at full width)
EXPECTED_DIFFERENCES = {
    ("seamless-m4t-large-v2", "decode_kernel"): ("rejected", "supported"),
}

SMALL = ["gpt2-medium", "bert-base", "resnet50", "resnet18", "deepseek-v2-lite-16b",
         "qwen2-1.5b", "gemma3-4b", "seamless-m4t-large-v2", "mamba2-2.7b"]


def check_config_against_reference(name):
    """Audit ``name`` on meta and hold every cell against the reference's
    committed matrix (the listed differences aside) and the port's committed
    snapshot: no shape-error anywhere."""
    cells = AB.audit_config(name)
    assert set(cells) == set(AB.PATH_IDS)
    for path, cell in cells.items():
        assert cell.status != AB.STATUS_ERROR, f"{name} × {path}: {cell.detail}"
        ref = REFERENCE["configs"][name][path]["status"]
        assert (ref, cell.status) == EXPECTED_DIFFERENCES.get((name, path), (ref, ref)), \
            f"{name} × {path}: reference {ref}, port {cell.status} ({cell.detail})"
        assert PORT["configs"][name][path]["status"] == cell.status
        if cell.status == AB.STATUS_REJECTED and ref == AB.STATUS_REJECTED:
            assert cell.detail == REFERENCE["configs"][name][path]["detail"]


@pytest.mark.parametrize("name", SMALL)
def test_audit_matches_reference(name):
    check_config_against_reference(name)


def test_reference_differences_are_the_listed_ones():
    listed = {k: v[:2] for k, v in AB.REFERENCE_DIFFERENCES.items()}
    assert listed == EXPECTED_DIFFERENCES
    assert all(why for _, _, why in AB.REFERENCE_DIFFERENCES.values())
    # the committed snapshot covers every config and path, in the reference's layout
    assert set(PORT["configs"]) == set(REFERENCE["configs"]) == set(AB.ALL_CONFIG_IDS)
    assert PORT["paths"] == REFERENCE["paths"] and PORT["probe"] == REFERENCE["probe"]
    assert AB.reference_differences(REFERENCE, PORT) == []


def test_snapshot_diff_and_markdown():
    drifted = json.loads(json.dumps(PORT))
    drifted["configs"]["qwen2-1.5b"]["prefill"]["status"] = AB.STATUS_ERROR
    assert AB.compare_matrices(PORT, PORT) == []
    assert AB.compare_matrices(PORT, drifted) == [
        "REGRESSION: qwen2-1.5b × prefill: supported -> shape-error"]
    assert AB.reference_differences(REFERENCE, drifted) != []
    cells = {n: {p: AB.Cell(n, p, c["status"], c.get("detail", "")) for p, c in v.items()}
             for n, v in PORT["configs"].items()}
    md = AB.render_markdown(cells)
    assert "| qwen2-1.5b | ✓ | ✓ | ✓ | ✓ | ✓ | ✓ | ✓ | ✓ | ✓ |" in md
    assert "Shape errors" not in md


def test_a_kernel_contract_refusal_is_rejected(monkeypatch):
    """A kernel contract that refuses a full-width shape is recorded as
    rejected, in the contract's words: qwen2's hd 128 with the decode
    kernel's head widths cut to (64, 256)."""
    monkeypatch.setattr(DA, "_SCALE", {64: 0.125, 256: 0.0625})
    cell = AB.audit_config("qwen2-1.5b", paths=("decode_kernel",))["decode_kernel"]
    assert cell.status == AB.STATUS_REJECTED
    assert cell.detail.startswith("decode_attention: needs hd in (64, 128, 256)")


# -- the kernels' meta contracts -------------------------------------------------

_g = torch.Generator().manual_seed(0)


def _rand(*shape, dtype=torch.float32):
    return torch.randn(shape, generator=_g).to(dtype)


def _meta(t):
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")


def _cases(dt):
    """(kernel, meta twin, plain version, its CPU operands, keywords) at a
    small shape of each kernel."""
    B, H, KH, S, hd = 3, 8, 2, 40, 64
    cache = _rand(B, S, KH, hd, dtype=dt)
    pos = torch.tensor([5, 17, 39])
    pool = _rand(12, 4, KH, hd, dtype=dt)
    table = torch.randperm(12, generator=_g)[:B * 3].reshape(B, 3).to(torch.int32)
    c_pool, kpe = _rand(12, 4, 64, dtype=dt), _rand(12, 4, 16, dtype=dt)
    x = _rand(2, 16, 4, 32, dtype=dt)
    bc = _rand(2, 16, 24, dtype=dt)
    dtt, A = torch.rand(2, 16, 4, generator=_g), -torch.rand(4, generator=_g)
    h, w = _rand(B, 96, dtype=dt), _rand(96, 320, dtype=dt)
    thr = torch.full((B,), 0.5)
    return {
        "decode_attention": (DA.decode_attention_meta, decode_attention_ref,
                             (_rand(B, H, hd, dtype=dt), cache.transpose(1, 2),
                              cache.transpose(1, 2), pos), {}),
        "paged_decode_attention": (DA.paged_decode_attention_meta, paged_decode_attention_ref,
                                   (_rand(B, H, hd, dtype=dt), pool, pool, table, pos), {}),
        "paged_mla_decode_attention": (
            DA.paged_mla_decode_attention_meta, paged_mla_decode_attention_ref,
            (_rand(B, 4, 64, dtype=dt), _rand(B, 4, 16, dtype=dt), c_pool, kpe, table, pos),
            {"scale": 0.125}),
        "flash_attention": (FA.flash_attention_meta, attention_ref,
                            (_rand(2, H, 24, hd, dtype=dt), cache[:2].transpose(1, 2),
                             cache[:2].transpose(1, 2)), {"causal": True, "window": 16}),
        "ssd_chunked": (SK.ssd_chunked_meta, ssd_chunked_ref,
                        (x.transpose(1, 2), dtt.transpose(1, 2), A, bc, bc), {"chunk": 64}),
        "ramp_head_stats": (RH.ramp_head_stats_meta, ramp_head_stats_ref, (h, w),
                            {"v_limit": 300}),
        "ramp_head_exit": (RH.ramp_head_exit_meta, ramp_head_exit_ref, (h, w.T.contiguous().T,
                                                                         thr),
                           {"v_limit": 300}),
    }


def _plain(name, ref, args, kw):
    if name.startswith("ramp_head"):
        return ref(*args, kw["v_limit"])
    if name == "ssd_chunked":
        return ref(*args, chunk=16)
    return ref(*args, **kw)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(_cases(torch.float32)))
def test_meta_outputs_match_plain_version(name, dt):
    """Each ``*_meta`` twin's outputs on meta copies of the operands have the
    shapes and dtypes of its plain version's outputs on the CPU tensors."""
    meta_fn, ref, args, kw = _cases(dt)[name]
    outs = _plain(name, ref, args, kw)
    metas = meta_fn(*[_meta(a) if torch.is_tensor(a) else a for a in args], **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    metas = metas if isinstance(metas, tuple) else (metas,)
    assert [(m.shape, m.dtype) for m in metas] == [(o.shape, o.dtype) for o in outs]
    assert all(m.device.type == "meta" for m in metas)


def _raises(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return e


@pytest.mark.parametrize("name", ["decode_attention", "paged_decode_attention",
                                  "paged_mla_decode_attention", "flash_attention",
                                  "ssd_chunked", "ramp_head"])
def test_meta_contracts_refuse_bad_shapes(name):
    """Each meta contract refuses what its wrapper's contract refuses, with
    the wrapper's words (the two share their checks): head widths, groups,
    ranks, table widths, widths past shared memory (``KernelShapeError``,
    which the audit records as rejected), and strides, dtypes and alignment
    (plain ``ValueError``)."""
    M = "meta"

    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device=M)

    if name == "decode_attention":
        e = _raises(DA.decode_attention_meta, t(2, 8, 96), t(2, 2, 16, 96), t(2, 2, 16, 96), 3)
        assert e.type is KernelShapeError and "hd in (64, 128, 256)" in str(e.value)
        e = _raises(DA.decode_attention_meta, t(2, 32, 64), t(2, 2, 16, 64), t(2, 2, 16, 64), 3)
        assert e.type is KernelShapeError and "H/KH <= 8" in str(e.value)
        e = _raises(DA.decode_attention_meta, t(2, 8, 64), t(2, 2, 16, 64, dtype=torch.float32),
                    t(2, 2, 16, 64), 3)
        assert "k dtype" in str(e.value)
        k = t(2, 16, 2, 68)[..., :64].transpose(1, 2)  # rows of 136 bytes
        e = _raises(DA.decode_attention_meta, t(2, 8, 64), k, k, 3)
        assert "16-byte aligned" in str(e.value)
        e = _raises(DA.decode_attention_meta, t(2, 8, 64), t(2, 2, 16, 64), t(2, 2, 16, 64),
                    torch.zeros(3, dtype=torch.int32, device=M))
        assert "pos has 3 values for 2 rows" in str(e.value)
    elif name == "paged_decode_attention":
        e = _raises(DA.paged_decode_attention_meta, t(2, 8, 64), t(6, 4, 2, 64), t(6, 4, 2, 64),
                    torch.empty(2, DA.MAX_TABLE_BLOCKS + 1, dtype=torch.int32, device=M), 3)
        assert e.type is KernelShapeError and "nb <=" in str(e.value)
    elif name == "paged_mla_decode_attention":
        e = _raises(DA.paged_mla_decode_attention_meta, t(2, 32, 512), t(2, 32, 64),
                    t(6, 4, 512), t(6, 4, 64), torch.zeros(2, 3, dtype=torch.int32, device=M),
                    3, scale=0.1)
        assert e.type is KernelShapeError and "got H=32 r=512 dr=64" in str(e.value)
        e = _raises(DA.paged_mla_decode_attention_meta, t(2, 16, 1024), t(2, 16, 64),
                    t(6, 4, 1024), t(6, 4, 64), torch.zeros(2, 3, dtype=torch.int32, device=M),
                    3, scale=0.1)
        assert e.type is KernelShapeError and "r <= 512" in str(e.value)
    elif name == "flash_attention":
        e = _raises(FA.flash_attention_meta, t(1, 4, 8, 320), t(1, 2, 8, 320), t(1, 2, 8, 320))
        assert e.type is KernelShapeError and "hd <= 256" in str(e.value)
        e = _raises(FA.flash_attention_meta, t(1, 3, 8, 64), t(1, 2, 8, 64), t(1, 2, 8, 64))
        assert e.type is KernelShapeError and "H a multiple of KH" in str(e.value)
        q = t(1, 8, 4, 60).transpose(1, 2)  # positions 480 bytes apart: not 16-byte multiples
        kv = t(1, 8, 2, 60).transpose(1, 2)
        e = _raises(FA.flash_attention_meta, q, kv, kv)
        assert "16-byte aligned" in str(e.value)
        e = _raises(FA.flash_attention_meta, t(1, 4, 8, 64), t(1, 2, 8, 64), t(1, 2, 8, 64),
                    window=0)
        assert "window must be >= 1" in str(e.value)
    elif name == "ssd_chunked":
        f32 = torch.float32
        e = _raises(SK.ssd_chunked_meta, t(1, 4, 16, 128), t(1, 4, 16, dtype=f32),
                    t(4, dtype=f32), t(1, 16, 64), t(1, 16, 64))
        assert e.type is KernelShapeError and "got hp=128 N=64" in str(e.value)
        e = _raises(SK.ssd_chunked_meta, t(1, 4, 16, 64), t(1, 4, 16, dtype=f32),
                    t(4, dtype=f32), t(1, 16, 64), t(1, 16, 64), chunk=32)
        assert e.type is KernelShapeError and "chunks by 64" in str(e.value)
    else:
        e = _raises(RH.ramp_head_stats_meta, t(8, 16384), t(16384, 1000))
        assert e.type is KernelShapeError and "no launch shape fits d=16384" in str(e.value)
        e = _raises(RH.ramp_head_stats_meta, t(8, 8192, dtype=torch.float32),
                    t(8192, 1000, dtype=torch.float32))
        assert e.type is KernelShapeError and "no launch shape fits d=8192" in str(e.value)
        e = _raises(RH.ramp_head_exit_meta, t(8, 512), t(512, 1000)[:, ::2],
                    torch.zeros(8, device=M))
        assert "contiguous along d or V" in str(e.value)


def test_ramp_head_fit_at_the_configs_widths():
    """The bf16 launch plan fits every config's d (8192 only with the
    two-stage ring) at batch 1-32 and no d past 9728 at any batch."""
    bf = torch.bfloat16
    for d in (768, 1024, 1536, 2048, 2560, 4096, 5120, 8192):
        for B in (1, 8, 32):
            assert RH.smem_fits(B, d, True, bf) and RH.smem_fits(B, d, False, bf)
    assert not any(RH.smem_fits(B, 10240, vmaj, bf) for B in (1, 8) for vmaj in (True, False))


def test_dispatchers_route_meta_cpu_and_other_devices():
    """The six dispatchers: meta to the contract (no value computed), the CPU
    to the plain version; a plain-version request on meta stays plain."""
    q, k = torch.empty(2, 4, 64, device="meta"), torch.empty(2, 2, 8, 64, device="meta")
    out = DO.attend_decode(q, k, k, 3)
    assert out.device.type == "meta" and out.shape == (2, 4, 64)
    assert DO.attend_decode(q, k, k, 3, use_kernel=False).device.type == "meta"
    cpu = DO.attend_decode(_rand(2, 4, 64), _rand(2, 2, 8, 64), _rand(2, 2, 8, 64), 3)
    assert cpu.device.type == "cpu"
    qa = torch.empty(1, 4, 8, 64, device="meta")
    assert attention(qa, qa[:, :2], qa[:, :2]).shape == (1, 4, 8, 64)
    x = torch.empty(1, 2, 16, 32, device="meta")
    y, st = ssd(x, torch.empty(1, 2, 16, device="meta"), torch.empty(2, device="meta"),
                torch.empty(1, 16, 8, device="meta"), torch.empty(1, 16, 8, device="meta"))
    assert y.shape == (1, 2, 16, 32) and st.shape == (1, 2, 32, 8)
    h, w = torch.empty(3, 64, device="meta"), torch.empty(64, 100, device="meta")
    rec = ramp_exit_decision(h, w, torch.empty(3, device="meta"))
    assert rec["exit"].device.type == "meta" and rec["label"].shape == (3,)
    assert ramp_confidence(h, w)["maxprob"].device.type == "meta"
    pools = torch.empty(6, 4, 64, device="meta")
    tab = torch.zeros(2, 3, dtype=torch.int32, device="meta")
    out = DO.attend_decode_paged_mla(torch.empty(2, 4, 64, device="meta"),
                                     torch.empty(2, 4, 16, device="meta"), pools,
                                     torch.empty(6, 4, 16, device="meta"), tab, 3, scale=0.1)
    assert out.shape == (2, 4, 64)
