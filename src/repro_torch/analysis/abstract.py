"""Meta-device config × feature-path support audit (the port's counterpart
of the reference's ``jax.eval_shape`` audit).

Traces every registered config at its full published width and depth
through each serving feature path with **no device work**: parameters and
caches are ``meta`` tensors (``meta_from_schema``), so PyTorch runs every
op's shape function and allocates and computes nothing. The kernel
switches are on (``prefill_attn='kernel'``, ``ssd_impl='kernel'``,
``pallas_head='kernel'``, ``decode_attn='kernel'`` or ``'paged-kernel'``,
absorbed MLA on the pool), so every kernel dispatcher takes its meta
branch and runs that kernel's own contract at each full-width shape
(``kernels/__init__.py``). Each (config, path) cell is classified:

* ``supported``   — the trace completes; the path exists for this config;
* ``rejected``    — an explicit ``NotImplementedError``: a documented gap,
  a path that is structurally n/a for the family (classifiers have no
  decode), or a kernel contract that refuses a full-width shape
  (``KernelShapeError``, with the contract's words);
* ``shape-error`` — any *other* exception: a silent support gap or shape
  bug. These fail the audit unconditionally.

``decode_sharded`` traces rank 0's shard at tp 2 (``_lm_decode_sharded``),
so the kernels' contracts meet the per-rank head counts too.

``python -m repro_torch.analysis --audit --write`` renders the result to
``support_matrix.json`` (the reference's layout) and ``SUPPORT_MATRIX.md``
beside this module; without ``--write`` it diffs the statuses against that
snapshot. ``REFERENCE_DIFFERENCES`` lists the cells where the port's
matrix differs from the reference's committed one, each with its reason.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import ARCH_IDS, PAPER_IDS, get_config
from repro_torch.models import build_model
from repro_torch.models.common import meta_from_schema

# Probe sizes, the reference's: a tiny batch and sequence; the weights are
# meta, so the full published widths and depths trace for free.
B = 2  # batch (slots)
S = 8  # prompt length
CHUNK = 4  # chunked-prefill first-chunk length (< CACHE_LEN)
CACHE_LEN = 16  # decode cache length
N_FRAMES = 8  # enc-dec source frames
BLOCK_SIZE = 4  # paged KV tokens per block
N_BLOCKS = 16  # paged KV pool blocks
MAX_BLOCKS = CACHE_LEN // BLOCK_SIZE  # per-row block-table width

STATUS_SUPPORTED = "supported"
STATUS_REJECTED = "rejected"
STATUS_ERROR = "shape-error"

# (path id, one-line description) — column order of the matrix.
FEATURE_PATHS: Tuple[Tuple[str, str], ...] = (
    ("prefill", "full-prompt prefill (or single-shot forward for classifier families)"),
    ("decode_dense", "single-token decode, dense masked-sdpa cache attention"),
    ("decode_kernel", "single-token decode through kernels/decode_attention (flash-decode)"),
    ("decode_paged", "single-token decode over the paged block-pool cache"),
    ("chunked_prefill", "first-chunk prefill into a cache longer than the chunk"),
    ("paged_block_schema", "paged (block-pool) cache schema construction"),
    ("ramp_heads", "forward with active early-exit ramp heads"),
    ("decode_fused_exit", "multi-step decode window (decode_multi + on-device thresholds)"),
    ("decode_sharded", "tensor-parallel sharded decode (tp=2): column-sharded attn/MLP, per-device KV shard"),
)
PATH_IDS = tuple(p for p, _ in FEATURE_PATHS)

ALL_CONFIG_IDS = tuple(PAPER_IDS) + tuple(ARCH_IDS)

# (config, path) -> (the reference's status, the port's, why). Every other
# cell equals the reference's committed support_matrix.json.
REFERENCE_DIFFERENCES: Dict[Tuple[str, str], Tuple[str, str, str]] = {
    ("seamless-m4t-large-v2", "decode_kernel"): (
        STATUS_REJECTED, STATUS_SUPPORTED,
        "the port's enc-dec decoder routes cfg.decode_attn through kernel #1 (ROADMAP "
        "Queue 3 item 1); the reference hardwires its dense masked softmax there"),
}


@dataclasses.dataclass(frozen=True)
class Cell:
    config: str
    path: str
    status: str
    detail: str = ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _tokens(b, s):
    return _meta((b, s), torch.int32)


def _kernels_on(cfg, **kw):
    """The config with the ramp heads through kernels #2/#3, and ``kw``."""
    return cfg.replace(pallas_head="kernel", **kw)


def _model(cfg):
    """The model with its prefill kernels on (#4, #7)."""
    if cfg.family == "lm":
        return build_model(cfg, prefill_attn="kernel", ssd_impl="kernel")
    if cfg.family in ("encdec", "encoder_cls"):
        return build_model(cfg, prefill_attn="kernel")
    return build_model(cfg)


def _routed_attn_slots(model) -> List:
    """Slots whose single-token decode goes through kernels/decode_attention
    (local windowed layers keep the dense path)."""
    cfg = model.cfg
    return [s for s in model.plan.layer_specs()
            if s.mixer == "attn" and not (s.is_local and cfg.window)]


def _n_active(model) -> int:
    sites = getattr(model, "sites", ())
    if not sites:
        raise NotImplementedError("config has no feasible ramp sites")
    return min(2, len(sites))


def _lm_prefill(model, *, s, cache_len, active=None):
    cfg = model.cfg
    kw = {}
    if cfg.cross_attn_every:
        kw["image_embeds"] = _meta((B, cfg.n_image_tokens, cfg.d_frontend), torch.float32)
    act = list(range(active)) if active is not None else None
    return model.prefill(model.abstract(), _tokens(B, s), cache_len=cache_len,
                         active_sites=act, **kw)


def _paged_args(model):
    """A meta pool of N_BLOCKS blocks of BLOCK_SIZE and (B, MAX_BLOCKS + the
    pinned xkv columns) int32 tables, as the runner ships them."""
    cache = model.paged_cache_schema(N_BLOCKS, BLOCK_SIZE)  # raises for unpageable slots
    nbx = model.paged_xkv_blocks(BLOCK_SIZE)
    return meta_from_schema(cache), _meta((B, MAX_BLOCKS + nbx), torch.int32)


def _lm_decode(cfg, *, decode_attn, paged=False, active=None):
    if paged and cfg.mla:
        cfg = cfg.replace(mla_absorbed=True)  # the paged MLA kernel's decode (#6)
    model = _model(_kernels_on(cfg, decode_attn=decode_attn))
    params = model.abstract()
    act = list(range(active)) if active else None
    pos = _meta((B,), torch.int32)
    if paged:
        cache, tables = _paged_args(model)
        return model.decode(params, cache, _tokens(B, 1), pos, active_sites=act,
                            block_tables=tables)
    cache = model.cache_abstract(B, CACHE_LEN)
    return model.decode(params, cache, _tokens(B, 1), pos, active_sites=act)


def _decode_window(model, cache):
    """``decode_multi``: a 2-step window with a (K,) device threshold vector
    and a bucket-padding row mask. Every row advances the same steps, so
    recurrent, MLA and ring caches stay consistent without carve-outs."""
    k = _n_active(model)
    return model.decode_multi(
        model.abstract(), cache, _tokens(B, 1), _meta((B,), torch.int32), 2, n_max=2,
        active_sites=list(range(k)), thresholds=_meta((k,), torch.float32),
        row_valid=_meta((B,), torch.bool))


def _lm_decode_sharded(cfg, tp: int = 2):
    """Tensor-parallel decode on rank 0 of a tp-2 model group, on meta
    (the reference's abstract-mesh probe): ``tp_check`` raises the
    documented per-mixer rejections, then ``decode`` runs with a ``TpCtx``
    whose gather is shape-only tiling, over rank 0's shard of the params
    (``tp_shard_params``) and of the contiguous cache (``tp_shard_cache``),
    the shapes each rank holds in ``decode_sharded``. #1 and #2 meet their
    per-rank shapes."""
    from repro_torch.models.transformer import TpCtx

    model = _model(_kernels_on(cfg, decode_attn="kernel"))
    model.tp_check(tp, dp=1, paged=False)
    params = model.tp_shard_params(model.abstract(), 0, tp)
    cache = model.tp_shard_cache(model.cache_abstract(B, CACHE_LEN), 0, tp)
    ctx = TpCtx(tp, lambda y: torch.cat([y] * tp, dim=-1))
    return model.decode(params, cache, _tokens(B, 1), _meta((B,), torch.int32), tp=ctx)


def _encdec_prefill(model, *, s, cache_len, active=None):
    act = list(range(active)) if active else None
    frames = _meta((B, N_FRAMES, model.cfg.d_frontend), torch.float32)
    return model.prefill(model.abstract(), frames, _tokens(B, s), cache_len=cache_len,
                         active_sites=act)


def _probe_lm(cfg, path):
    model = _model(_kernels_on(cfg))
    if path == "prefill":
        _lm_prefill(model, s=S, cache_len=S)
    elif path == "decode_dense":
        _lm_decode(cfg, decode_attn="dense")
    elif path == "decode_kernel":
        if not _routed_attn_slots(model):
            raise NotImplementedError(
                "no full-attention layers route through kernels/decode_attention "
                "(every slot is MLA, mamba, or local-windowed)")
        _lm_decode(cfg, decode_attn="kernel")
    elif path == "decode_paged":
        _lm_decode(cfg, decode_attn="paged-kernel", paged=True)
    elif path == "chunked_prefill":
        _lm_prefill(model, s=CHUNK, cache_len=CACHE_LEN)
    elif path == "paged_block_schema":
        model.paged_cache_schema(N_BLOCKS, BLOCK_SIZE)
    elif path == "ramp_heads":
        _lm_prefill(model, s=S, cache_len=S, active=_n_active(model))
    elif path == "decode_fused_exit":
        _decode_window(model, model.cache_abstract(B, CACHE_LEN))
    elif path == "decode_sharded":
        _lm_decode_sharded(cfg)


def _probe_encdec(cfg, path):
    model = _model(_kernels_on(cfg))
    if path == "prefill":
        _encdec_prefill(model, s=S, cache_len=S)
    elif path in ("decode_dense", "decode_kernel"):
        m = _model(_kernels_on(cfg, decode_attn="dense" if path == "decode_dense"
                               else "kernel"))
        cache, _ = _encdec_prefill(m, s=S, cache_len=CACHE_LEN)
        m.decode(m.abstract(), cache, _tokens(B, 1), _meta((), torch.int32))
    elif path == "decode_paged":
        # self-attention walks the token columns through #5; the cross layers
        # gather their pinned read-only xkv pages through the trailing columns
        m = _model(_kernels_on(cfg, decode_attn="paged-kernel"))
        cache, tables = _paged_args(m)
        m.decode(m.abstract(), cache, _tokens(B, 1), _meta((B,), torch.int32),
                 block_tables=tables)
    elif path == "paged_block_schema":
        model.paged_cache_schema(N_BLOCKS, BLOCK_SIZE)
    elif path == "chunked_prefill":
        _encdec_prefill(model, s=CHUNK, cache_len=CACHE_LEN)
    elif path == "ramp_heads":
        _encdec_prefill(model, s=S, cache_len=S, active=_n_active(model))
    elif path == "decode_fused_exit":
        cache, _ = _encdec_prefill(model, s=S, cache_len=CACHE_LEN)
        _decode_window(model, cache)
    elif path == "decode_sharded":
        raise NotImplementedError(
            "sharded decode wires the decoder-only LM stack; the enc-dec decoder (pinned "
            "cross-attn memory) keeps the single-device path")


def _probe_classifier(cfg, path):
    model = _model(cfg)
    if cfg.family == "encoder_cls":
        x = _tokens(B, S)
    else:
        x = _meta((B, cfg.img_size, cfg.img_size, 3), torch.float32)
    if path == "prefill":
        model.forward(model.abstract(), x)
    elif path == "ramp_heads":
        model.forward(model.abstract(), x, active_sites=list(model.sites[:_n_active(model)]))
    else:
        raise NotImplementedError(
            f"{cfg.family} family is single-shot (no decode / incremental prefill)")


def probe(cfg, path: str) -> None:
    """Run one (config, path) probe on meta tensors; raises on rejection or a
    bug, returns on success. Nothing runs on a device."""
    if cfg.family == "lm":
        return _probe_lm(cfg, path)
    if cfg.family == "encdec":
        return _probe_encdec(cfg, path)
    if cfg.family in ("encoder_cls", "resnet"):
        return _probe_classifier(cfg, path)
    raise NotImplementedError(f"unknown family {cfg.family!r}")


_WS = re.compile(r"\s+")


def _clip(msg: str, n: int = 200) -> str:
    msg = _WS.sub(" ", msg).strip()
    return msg if len(msg) <= n else msg[: n - 1] + "…"


def audit_config(name: str, paths: Sequence[str] = PATH_IDS) -> Dict[str, Cell]:
    cfg = get_config(name)
    out: Dict[str, Cell] = {}
    for path in paths:
        try:
            with torch.no_grad():
                probe(cfg, path)
        except NotImplementedError as e:
            out[path] = Cell(name, path, STATUS_REJECTED, _clip(str(e) or "not implemented"))
        except Exception as e:  # noqa: BLE001 — any other failure IS the signal
            out[path] = Cell(name, path, STATUS_ERROR, _clip(f"{type(e).__name__}: {e}"))
        else:
            out[path] = Cell(name, path, STATUS_SUPPORTED)
    return out


def audit_all(configs: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, Cell]]:
    return {name: audit_config(name) for name in (configs or ALL_CONFIG_IDS)}


# -- snapshot (json) ---------------------------------------------------------


def to_json(matrix: Dict[str, Dict[str, Cell]]) -> dict:
    return {
        "schema_version": 1,
        "probe": {
            "B": B, "S": S, "chunk": CHUNK, "cache_len": CACHE_LEN,
            "n_blocks": N_BLOCKS, "block_size": BLOCK_SIZE,
        },
        "paths": list(PATH_IDS),
        "configs": {
            name: {
                p: {"status": c.status, **({"detail": c.detail} if c.detail else {})}
                for p, c in cells.items()
            }
            for name, cells in matrix.items()
        },
    }


def compare_matrices(committed: dict, fresh: dict) -> List[str]:
    """Status-only diff. Returns human-readable drift lines; empty == pass.
    ``supported`` -> anything is a *regression*; other changes are drift
    (also failing — the snapshot must be regenerated deliberately)."""
    problems: List[str] = []
    old_cfgs = committed.get("configs", {})
    new_cfgs = fresh.get("configs", {})
    for name in sorted(set(old_cfgs) | set(new_cfgs)):
        if name not in new_cfgs:
            problems.append(f"{name}: config disappeared from the audit")
            continue
        if name not in old_cfgs:
            problems.append(f"{name}: new config not in committed snapshot (run --write)")
            continue
        old_cells, new_cells = old_cfgs[name], new_cfgs[name]
        for path in sorted(set(old_cells) | set(new_cells)):
            old = old_cells.get(path, {}).get("status")
            new = new_cells.get(path, {}).get("status")
            if old == new:
                continue
            kind = "REGRESSION" if old == STATUS_SUPPORTED else "drift"
            problems.append(f"{kind}: {name} × {path}: {old} -> {new}")
    return problems


def reference_differences(reference: dict, fresh: dict) -> List[str]:
    """The port's statuses against the reference's committed matrix: a line
    for every cell that differs otherwise than ``REFERENCE_DIFFERENCES``
    says (and for every listed difference that no longer holds)."""
    problems = []
    for name, cells in reference["configs"].items():
        for path, cell in cells.items():
            ref = cell["status"]
            port = fresh["configs"].get(name, {}).get(path, {}).get("status")
            want = REFERENCE_DIFFERENCES.get((name, path), (ref, ref, ""))
            if (ref, port) != want[:2]:
                problems.append(f"{name} × {path}: reference {ref}, port {port}, "
                                f"expected {want[1]}")
    return problems


def shape_error_cells(matrix: Dict[str, Dict[str, Cell]]) -> List[Cell]:
    return [
        c for cells in matrix.values() for c in cells.values()
        if c.status == STATUS_ERROR
    ]


# -- markdown ----------------------------------------------------------------

_GLYPH = {STATUS_SUPPORTED: "✓", STATUS_REJECTED: "—", STATUS_ERROR: "✗ BUG"}


def render_markdown(matrix: Dict[str, Dict[str, Cell]]) -> str:
    lines = [
        "# Config × feature-path support matrix (the PyTorch port)",
        "",
        "<!-- GENERATED by `python -m repro_torch.analysis --audit --write` — do not edit. -->",
        "",
        "Derived entirely on the `meta` device (shapes and dtypes, no device",
        "work), every config at full published width and depth, the kernel",
        "switches on, so each kernel's contract meets every full-width shape.",
        "`✓` = path traces for this config; `—` = explicit",
        "`NotImplementedError` (documented gap or a kernel contract's refusal);",
        "`✗ BUG` = unexpected shape/trace error.",
        "",
        f"Probe sizes: B={B}, S={S}, chunk={CHUNK}, cache_len={CACHE_LEN}, "
        f"paged pool {N_BLOCKS}×{BLOCK_SIZE} tokens.",
        "",
    ]
    header = ["config"] + [p for p in PATH_IDS]
    lines.append("| " + " | ".join(header) + " |")
    lines.append("|" + "---|" * len(header))
    for name in matrix:
        cells = matrix[name]
        row = [name] + [_GLYPH.get(cells[p].status, "?") for p in PATH_IDS]
        lines.append("| " + " | ".join(row) + " |")
    lines += ["", "## Feature paths", ""]
    for pid, desc in FEATURE_PATHS:
        lines.append(f"- **{pid}** — {desc}")
    lines += ["", "## Rejected cells (explicit `NotImplementedError`)", ""]
    rows = [f"- `{name}` × `{p}`: {cells[p].detail}" for name, cells in matrix.items()
            for p in PATH_IDS if cells[p].status == STATUS_REJECTED]
    lines += rows or ["(none)"]
    lines += ["", "## Differences from the reference's matrix", ""]
    for (name, p), (ref, port, why) in REFERENCE_DIFFERENCES.items():
        lines.append(f"- `{name}` × `{p}`: reference {ref}, port {port}: {why}")
    err = shape_error_cells(matrix)
    if err:
        lines += ["", "## Shape errors (BUGS)", ""]
        for c in err:
            lines.append(f"- `{c.config}` × `{c.path}`: {c.detail}")
    lines.append("")
    return "\n".join(lines)
