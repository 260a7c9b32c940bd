"""Layerwise latency profiles.

The paper profiles per-layer runtimes once per model (different batch
sizes) and uses them for (a) ramp utility scoring and (b) translating exit
locations into latency savings. The profile is derived analytically from
the architecture's per-layer FLOPs / bytes and the NVIDIA H100's published
roofline peaks, so measured profiles can drop in unchanged. Times it gives
are a model of the card, not measurements of it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM, published dense peaks at its full 700 W power limit (a
# card capped below 700 W runs slower under load)
PEAK_FLOPS = 989e12  # bf16 tensor cores
HBM_BW = 3.35e12  # B/s
ICI_BW = 450e9  # B/s each way over NVLink to the host's other cards


def _layer_flops_bytes(
    cfg, seq: int, mode: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-layer (FLOPs, weight HBM bytes, per-input HBM bytes) for one input
    at seq length `seq`. mode: 'prefill' (process seq tokens) | 'decode'
    (1 token, seq-long cache). Weight bytes are loaded once per batch;
    per-input bytes (KV-cache / recurrent-state traffic) scale with batch
    size — the split is what makes per-token early exits save real time in
    the memory-bound decode regime."""
    from repro_torch.models.transformer import build_plan

    d = cfg.d_model
    bpe = 2  # bf16
    if cfg.family == "resnet":
        f, b = _resnet_flops_bytes(cfg)
        return f, b, np.zeros_like(b)
    if cfg.family in ("encdec", "encoder_cls"):
        L = cfg.n_dec_layers if cfg.family == "encdec" else cfg.n_layers
        specs = ["attn"] * L
    else:
        specs = [s.mixer for s in build_plan(cfg).layer_specs()]
    flops, bytes_, bytes_pi = [], [], []
    ntok = seq if mode == "prefill" else 1
    kvlen = seq
    for i, mixer in enumerate(specs):
        f = b = bpi = 0.0
        if mixer == "attn":
            H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
            wqkvo = d * H * hd * 2 + d * K * hd * 2 + H * hd * d
            f += 2 * ntok * wqkvo
            b += wqkvo * bpe
            att_len = min(kvlen, cfg.window) if (cfg.window and _is_local(cfg, i)) else kvlen
            f += 2 * ntok * att_len * (H * hd) * 2  # qk + pv
            bpi += ntok * att_len * K * hd * 2 * bpe if mode == "decode" else 0
        elif mixer == "mla":
            r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
            H = cfg.n_heads
            w = d * H * (dn + dr) + d * (r + dr) + r * H * dn + r * H * dv + H * dv * d
            f += 2 * ntok * w
            b += w * bpe
            if mode == "decode":
                # naive path re-expands the latent cache per step
                f += 2 * kvlen * r * H * (dn + dv)
                bpi += kvlen * (r + dr) * bpe
            f += 2 * ntok * kvlen * H * (dn + dr + dv)
        elif mixer == "mamba":
            di, N, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_headdim
            Hs, G = di // hp, cfg.ssm_ngroups
            w = d * (2 * di + 2 * G * N + Hs) + di * d
            f += 2 * ntok * w
            b += w * bpe
            f += ntok * (di * N * 6)  # ssd state update + output
            bpi += Hs * hp * N * 4 if mode == "decode" else 0
        # ffn
        ffn_kind = _ffn_kind(cfg, i)
        if ffn_kind == "dense":
            w = 3 * d * cfg.d_ff
            f += 2 * ntok * w
            b += w * bpe
        elif ffn_kind == "moe":
            w_active = 3 * d * cfg.moe_d_ff * (cfg.top_k + cfg.n_shared_experts)
            f += 2 * ntok * w_active
            # decode touches top_k expert weights per token
            b += w_active * bpe
        flops.append(f)
        bytes_.append(b)
        bytes_pi.append(bpi)
    return np.asarray(flops), np.asarray(bytes_), np.asarray(bytes_pi)


def _layer_kv_fill(cfg) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-layer (FLOPs, weight bytes, per-token bytes) to *catch up* one
    exited token's sequence state at that layer.

    The paper's generative mode: a token exiting at ramp `s` skips layers
    > s, but future tokens still attend to it — so each deeper attention
    layer needs this token's K/V (filled from the exit layer's hidden
    state via the k/v projections only), and each deeper SSM layer must
    still run its recurrent state update (sequential state cannot be
    approximated away). This is the deferred ``kv_fill_cost`` the serving
    engine amortizes into the following decode step — exits are never
    free."""
    from repro_torch.models.transformer import build_plan

    d = cfg.d_model
    bpe = 2
    if cfg.family == "resnet":
        z = np.zeros(sum(cfg.resnet_blocks))
        return z, z.copy(), z.copy()
    if cfg.family in ("encdec", "encoder_cls"):
        L = cfg.n_dec_layers if cfg.family == "encdec" else cfg.n_layers
        specs = ["attn"] * L
    else:
        specs = [s.mixer for s in build_plan(cfg).layer_specs()]
    f_l, wb_l, pib_l = [], [], []
    for mixer in specs:
        f = wb = pib = 0.0
        if mixer == "attn":
            K, hd = cfg.n_kv_heads, cfg.hd
            wkv = d * K * hd * 2  # k + v projections
            f = 2 * wkv
            wb = wkv * bpe
            pib = K * hd * 2 * bpe + d * bpe  # cache write + hidden read
        elif mixer == "mla":
            r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
            wkv = d * (r + dr)  # latent + rope-key projection
            f = 2 * wkv
            wb = wkv * bpe
            pib = (r + dr) * bpe + d * bpe
        elif mixer == "mamba":
            # the recurrence is sequential: the full mixer runs for the
            # exited token (no cheap fill exists for SSM state)
            di, N, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_headdim
            Hs, G = di // hp, cfg.ssm_ngroups
            w = d * (2 * di + 2 * G * N + Hs) + di * d
            f = 2 * w + di * N * 6
            wb = w * bpe
            pib = Hs * hp * N * 4 + d * bpe
        f_l.append(f)
        wb_l.append(wb)
        pib_l.append(pib)
    return np.asarray(f_l), np.asarray(wb_l), np.asarray(pib_l)


def _is_local(cfg, i: int) -> bool:
    if not cfg.local_global_pattern:
        return False
    return (i % (cfg.local_global_pattern + 1)) < cfg.local_global_pattern


def _ffn_kind(cfg, i: int) -> str:
    if cfg.family == "resnet":
        return "none"
    if cfg.ssm and not cfg.hybrid_period:
        return "none"
    if cfg.hybrid_period:
        return "moe" if (cfg.moe and i % cfg.moe_every == 1) else "dense"
    if cfg.moe:
        return "dense" if i < cfg.first_k_dense else "moe"
    return "dense"


def _resnet_flops_bytes(cfg) -> Tuple[np.ndarray, np.ndarray]:
    """Per-residual-block FLOPs for img_size inputs (CV latency skews early —
    exactly the skew the paper calls out in §3.3)."""
    flops, bytes_ = [], []
    hw = cfg.img_size
    cin = cfg.resnet_widths[0]
    for stage, (n, w) in enumerate(zip(cfg.resnet_blocks, cfg.resnet_widths)):
        wout = w * (4 if cfg.resnet_bottleneck else 1)
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            hw = hw // stride
            if cfg.resnet_bottleneck:
                f = 2 * hw * hw * (cin * w + 9 * w * w + w * wout)
                nbytes = (cin * w + 9 * w * w + w * wout) * 4
            else:
                f = 2 * hw * hw * (9 * cin * w + 9 * w * wout)
                nbytes = (9 * cin * w + 9 * w * wout) * 4
            flops.append(f)
            bytes_.append(nbytes)
            cin = wout
    return np.asarray(flops, np.float64), np.asarray(bytes_, np.float64)


@dataclasses.dataclass
class LatencyProfile:
    """Cumulative layerwise serving-time model.

    layer_flops/layer_bytes: per-layer, per-input (reference seq);
    layer_bytes are weight traffic (loaded once per batch) while
    layer_bytes_pi is per-input traffic (KV cache / recurrent state) that
    scales with batch size.
    head_flops/head_bytes: final head (norm + unembed).
    ramp_flops/ramp_bytes: per-site ramp overhead.
    kv_flops/kv_wbytes/kv_pibytes: per-layer cost to catch up one exited
    token's KV / recurrent state at that layer (generative decode; the
    paper's deferred hidden-state copy + KV-projection fill).
    chips: devices the model is sharded over.
    """

    layer_flops: np.ndarray
    layer_bytes: np.ndarray
    head_flops: float
    head_bytes: float
    ramp_flops: np.ndarray
    ramp_bytes: np.ndarray
    sites: Tuple[int, ...]
    chips: int = 1
    flops_scale: float = 1.0  # efficiency derate (MXU util)
    layer_bytes_pi: Optional[np.ndarray] = None  # per-input bytes (KV reads)
    kv_flops: Optional[np.ndarray] = None
    kv_wbytes: Optional[np.ndarray] = None
    kv_pibytes: Optional[np.ndarray] = None
    charge_kv_in_savings: bool = False  # net exit savings of KV catch-up

    def _time(self, flops, nbytes, bs: int, nbytes_pi: float = 0.0) -> float:
        """Roofline time (ms) for a batch of `bs` inputs."""
        c = max(self.chips, 1)
        t_c = flops * bs / (PEAK_FLOPS * c * self.flops_scale)
        t_m = (nbytes + bs * nbytes_pi) / (HBM_BW * c)
        return float(np.maximum(t_c, t_m)) * 1e3

    def _layer_pi(self, i: int) -> float:
        return float(self.layer_bytes_pi[i]) if self.layer_bytes_pi is not None else 0.0

    def layer_time(self, i: int, bs: int) -> float:
        return self._time(self.layer_flops[i], self.layer_bytes[i], bs, self._layer_pi(i))

    def time_to_layer(self, i: int, bs: int) -> float:
        """Time through layer i inclusive (no ramps, no head)."""
        return sum(self.layer_time(j, bs) for j in range(i + 1))

    def head_time(self, bs: int) -> float:
        return self._time(self.head_flops, self.head_bytes, bs)

    def ramp_overhead(self, site_idx: int, bs: int) -> float:
        return self._time(self.ramp_flops[site_idx], self.ramp_bytes[site_idx], bs)

    def vanilla_time(self, bs: int) -> float:
        return self.time_to_layer(len(self.layer_flops) - 1, bs) + self.head_time(bs)

    def time_to_site(self, site_idx: int, bs: int) -> float:
        """Time until ramp at `site_idx` produces its result (incl. its own
        head compute)."""
        return self.time_to_layer(self.sites[site_idx], bs) + self.ramp_overhead(site_idx, bs)

    def savings_at_site(self, site_idx: int, bs: int) -> float:
        """Latency avoided by releasing at this site (paper's savings).
        With ``charge_kv_in_savings`` (generative decode profiles) the
        deferred KV catch-up for the exited token is netted out, so the
        whole adaptation stack (threshold tuning, ramp utilities) scores
        exits by their true decode value."""
        raw = self.vanilla_time(bs) - self.time_to_layer(self.sites[site_idx], bs)
        if self.charge_kv_in_savings:
            raw -= self.kv_fill_cost(site_idx, 1)
        return raw

    # -- generative decode (per-token exits; paper §5 generative results) ----

    def kv_fill_cost(self, site_idx: int, n_tokens: int = 1) -> float:
        """Deferred catch-up cost (ms) for ``n_tokens`` tokens that exited at
        ``site_idx`` in the same decode step: deeper attention layers still
        need each token's K/V (filled from the exit layer's hidden state via
        the k/v projections) and deeper SSM layers must run their recurrent
        state update. Weight traffic amortizes across the step's exited
        tokens; per-token traffic does not."""
        if self.kv_flops is None or n_tokens <= 0:
            return 0.0
        lo = self.sites[site_idx] + 1
        if lo >= len(self.kv_flops):
            return 0.0
        return self._time(
            float(self.kv_flops[lo:].sum()),
            float(self.kv_wbytes[lo:].sum()),
            n_tokens,
            float(self.kv_pibytes[lo:].sum()),
        )

    def prefill_chunk_time(self, n_tokens: int, bs: int = 1) -> float:
        """Roofline time (ms) for one prefill chunk of ``n_tokens`` prompt
        tokens per input: each layer's compute scales with the chunk while
        its weight traffic is paid once per chunk — prefill is the
        compute-dense regime chunked prefill co-schedules against
        memory-bound decode steps. Sub-additive in the chunk size (weight
        reads amortize: two merged chunks never cost more than the split),
        which is exactly why a chunk must be priced as a unit instead of
        ``n_tokens`` independent decode-step fractions. The serving
        engine's default admission pricing stays the engine-level
        ``prefill_frac`` model (linear, so chunked and unchunked totals
        match exactly); this method is the physical reference — pass it as
        ``GenerativeEngine(prefill_ms=profile.prefill_chunk_time)`` to
        price prefill from the roofline instead."""
        if n_tokens <= 0:
            return 0.0
        t = 0.0
        for i in range(len(self.layer_flops)):
            t += self._time(self.layer_flops[i] * n_tokens, self.layer_bytes[i],
                            bs, self._layer_pi(i) * n_tokens)
        return t

    def decode_step_time(self, exit_sites: Sequence[int], active: Sequence[int] = ()) -> float:
        """One continuous-batching decode step (ms) where slot ``b``'s token
        exits at site ``exit_sites[b]`` (-1 = runs to completion).

        The per-layer batch shrinks as tokens peel off at their exit sites:
        a layer pays its weight traffic only while at least one token is
        still alive, plus per-alive-token KV traffic and compute. Active
        ramp heads run over the tokens alive at their site; the final LM
        head runs only over non-exited tokens. With no exits and no ramps
        this equals ``vanilla_time(B)`` exactly."""
        ex = np.asarray(exit_sites, np.int64)
        B = len(ex)
        if B == 0:
            return 0.0
        L = len(self.layer_flops)
        # token b is alive at layer j iff it never exits or exits at a site
        # whose layer is >= j (it runs through its exit layer inclusive)
        sites_arr = np.asarray(self.sites, np.int64)
        last_layer = np.where(ex >= 0, sites_arr[np.clip(ex, 0, len(sites_arr) - 1)], L - 1)
        t = 0.0
        alive_at = np.zeros(L, np.int64)
        for j in range(L):
            alive_at[j] = int((last_layer >= j).sum())
            if alive_at[j] > 0:
                t += self.layer_time(j, int(alive_at[j]))
        for k, s in enumerate(sorted(active)):
            n = int(alive_at[self.sites[s]])
            if n > 0:
                t += self.ramp_overhead(s, n)
        n_full = int((ex < 0).sum())
        if n_full > 0:
            t += self.head_time(n_full)
        return t

    # convenience vectors (reference batch size)

    def cum_times(self, bs: int) -> np.ndarray:
        t = np.cumsum([self.layer_time(j, bs) for j in range(len(self.layer_flops))])
        return t

    def max_ramps_within_budget(self, budget_frac: float, bs: int) -> int:
        ovh = np.sort([self.ramp_overhead(s, bs) for s in range(len(self.sites))])
        lim = budget_frac * self.vanilla_time(bs)
        return int(np.searchsorted(np.cumsum(ovh), lim, side="right"))


def build_profile(
    cfg,
    *,
    seq: int = 2048,
    mode: str = "decode",
    chips: int = 1,
    sites: Optional[Sequence[int]] = None,
    ramp_cost_mult: float = 1.0,
    flops_scale: float = 0.6,
    charge_kv: bool = False,
) -> LatencyProfile:
    lf, lb, lbpi = _layer_flops_bytes(cfg, seq, mode)
    if cfg.family == "resnet":
        head_f = 2 * cfg.resnet_widths[-1] * (4 if cfg.resnet_bottleneck else 1) * cfg.n_classes
        head_b = head_f * 2
        if sites is None:
            from repro_torch.models import build_model

            sites = build_model(cfg).sites
        widths = _resnet_widths(cfg)
        rf = np.asarray([2 * widths[s] * cfg.n_classes for s in sites], np.float64)
        rb = rf * 2.0
    else:
        ntok = 1 if mode == "decode" else seq
        # classification-served models (the paper's own: BERT/GPT2 sentiment)
        # have tiny heads; token-serving LMs pay the full (padded) vocab head.
        out_width = cfg.n_classes if cfg.n_classes > 0 else cfg.padded_vocab
        head_f = 2 * ntok * cfg.d_model * out_width
        head_b = cfg.d_model * out_width * 2
        if sites is None:
            if cfg.family == "lm":
                from repro_torch.models.transformer import ramp_sites

                sites = ramp_sites(cfg)
            else:
                from repro_torch.models import build_model

                sites = build_model(cfg).sites
        rf = np.full(len(sites), 2.0 * cfg.d_model * out_width * ramp_cost_mult)
        if cfg.ramp_style == "tied":
            # beyond-paper: ramp head shares the LM-head weights -> no extra
            # HBM traffic beyond the per-site norm vector; compute unchanged.
            rb = np.full(len(sites), cfg.d_model * 4.0 * ramp_cost_mult)
        else:
            rb = np.full(len(sites), cfg.d_model * out_width * 2.0 * ramp_cost_mult)
    kvf, kvw, kvp = _layer_kv_fill(cfg)
    return LatencyProfile(
        layer_flops=lf,
        layer_bytes=lb,
        head_flops=float(head_f),
        head_bytes=float(head_b),
        ramp_flops=np.asarray(rf, np.float64),
        ramp_bytes=np.asarray(rb, np.float64),
        sites=tuple(sites),
        chips=chips,
        flops_scale=flops_scale,
        layer_bytes_pi=lbpi,
        kv_flops=kvf,
        kv_wbytes=kvw,
        kv_pibytes=kvp,
        charge_kv_in_savings=charge_kv,
    )


def _resnet_widths(cfg):
    widths = []
    for n, w in zip(cfg.resnet_blocks, cfg.resnet_widths):
        widths += [w * (4 if cfg.resnet_bottleneck else 1)] * n
    return widths
