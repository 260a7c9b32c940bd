"""Exit-gated pipeline decode windows (the port's counterpart of the JAX
package's ``distributed/pipeline.py`` serving path).

``pipeline_decode_window`` decodes a multi-token window over period blocks
split into stages, one rank a stage, where per-row EARLY-EXIT masks gate
the forwarding: a row whose boundary ramp fires takes the ramp label as its
token and never enters later stages (its slot in the microbatch stops
counting in later stages' ``stage_steps``), the paper's exit turned into
saved stage work. When every row of a microbatch has exited, its payload
goes inert and the window can end early. One stage is plain batched
multi-step decode.

``pipeline_apply`` is the reference's GPipe forward demonstrator: a stack
of identical stages, one rank a stage, microbatches streaming through the
``(S + M - 1)``-tick schedule on the ring.
"""
from __future__ import annotations

import weakref
from typing import Callable, Optional

import torch

from repro_torch.models.common import tree_map
from repro_torch.models.transformer import _mask_pad_vocab, _stats


def pipeline_apply(mesh, axis: str, stage_fn: Callable, stage_params, x: torch.Tensor):
    """The reference's ``pipeline_apply``: ``x`` (n_micro, mb, ...) through
    the ``S`` stages on the mesh axis ``axis``, one rank a stage.
    ``stage_params`` is this rank's stage's slice of the stacked params
    (the leading stage axis taken away); ``stage_fn(stage_params, h)``
    keeps ``h``'s shape. At tick ``t`` stage ``s`` runs microbatch ``t -
    s``: stage 0 takes it from ``x``, a later stage from the ring
    (``ring_shift``); the last stage writes its output. A stage skips its
    bubble ticks (their results are never written) but still takes part
    in the ring. The outputs live on the last stage; a sum over the stage
    group, where every other stage holds zeros, gives them to every rank
    exactly, as the reference's ``psum`` does. Returns (n_micro, mb, ...)
    on every rank."""
    from repro_torch.distributed.collectives import ring_shift, sum_over

    S, sid, group = mesh.shape[axis], mesh.coords[axis], mesh.groups[axis]
    M = x.shape[0]
    outs = torch.zeros_like(x)
    buf = torch.zeros_like(x[0])
    for t in range(M + S - 1):
        if sid <= t < sid + M:
            y = stage_fn(stage_params, x[t] if sid == 0 else buf)
            if sid == S - 1:
                outs[t - sid] = y
        else:  # a bubble tick: what it sends is never read
            y = torch.zeros_like(buf)
        if S > 1:
            (buf,) = ring_shift([y.to(buf.dtype)], group)
    return sum_over(outs, group) if S > 1 else outs


def pipeline_check(model, n_stages: int, batch: Optional[int] = None) -> None:
    """Raise ``NotImplementedError`` (why-note surfaced by the support
    matrix) when this plan/config cannot run the exit-gated pipeline
    decode path at ``n_stages`` stages."""
    cfg, plan = model.cfg, model.plan
    if plan.prefix or plan.suffix:
        raise NotImplementedError(
            "pipeline decode shards the scanned period blocks only: plans "
            "with prefix/suffix layers (first_k_dense, trailing globals) "
            "have no uniform stage split"
        )
    for slot in plan.period:
        if slot.mixer != "attn" or slot.cross:
            raise NotImplementedError(
                f"pipeline decode supports attention-mixer stages only "
                f"(got mixer={slot.mixer!r}, cross={slot.cross})"
            )
        if slot.ffn == "moe":
            raise NotImplementedError(
                "pipeline decode stages run single-device: MoE slots need "
                "the expert-parallel `model` axis the stage mesh does not "
                "carry"
            )
        if slot.is_local:
            raise NotImplementedError(
                "local-window slots pin ring caches whose chronological "
                "gather is not stage-local"
            )
    if cfg.window:
        raise NotImplementedError("windowed attention plans are not staged")
    if str(getattr(cfg, "decode_attn", "ref")).startswith("paged"):
        raise NotImplementedError(
            "pipeline decode reads the contiguous slot cache; the paged "
            "block pool shards per-device over `model`, not over stages"
        )
    if str(cfg.pallas_head) != "off":
        raise NotImplementedError(
            "the fused ramp-head kernel is per-device; pipeline boundary "
            "ramps use the dense head"
        )
    if plan.n_periods % n_stages:
        raise NotImplementedError(
            f"n_periods={plan.n_periods} not divisible by "
            f"n_stages={n_stages}"
        )
    if batch is not None and batch % n_stages:
        raise NotImplementedError(
            f"decode batch {batch} not divisible into {n_stages} "
            "microbatches"
        )


def stage_shard(tree: dict, stage: int, n_stages: int) -> dict:
    """Stage ``stage``'s share of a params or contiguous-cache tree: its
    periods ``[s*L/S, (s+1)*L/S)`` of every ``blocks`` leaf (views; the
    period axis leads), everything else whole."""
    def part(x):
        n = x.shape[0] // n_stages
        return x.narrow(0, stage * n, n)

    return {k: (tree_map(part, v) if k == "blocks" else v) for k, v in tree.items()}


def _stage_model(model, n_stages: int):
    """The model of one stage's periods (its ``_stack`` walks them), built
    once for each model and stage count."""
    per = _STAGE_MODELS.setdefault(model, {})
    if n_stages not in per:
        plan = model.plan
        per[n_stages] = type(model)(model.cfg.replace(
            n_layers=plan.n_periods // n_stages * len(plan.period)))
    return per[n_stages]


_STAGE_MODELS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def pipeline_decode_window(model, params, cache, tokens, pos, n_steps: int, *, mesh,
                           active_sites=None, thresholds=None):
    """A multi-token decode window over the period blocks split into
    ``S = mesh.pp`` stages, with EXIT-GATED forwarding. This rank is stage
    ``s = mesh.stage`` and owns periods ``[s*L/S, (s+1)*L/S)``: ``params``
    and ``cache`` are its share (``stage_shard`` of the whole trees; the
    cache is the contiguous one, so per-rank KV bytes are ``total / S``).
    The batch splits into ``S`` microbatches that tick through the stages
    on a send/receive ring (``ring_shift``): one payload is resident per
    stage per tick, so after the fill every stage works every tick and a
    token step of a microbatch takes ``S`` ticks.

    Early-exit contract (the Apparate pipeline escape): after its last
    local period a non-final stage evaluates the boundary ramp of any
    ``active_sites`` entry at that layer; a row whose uncertainty is under
    the threshold (strict ``<``, as ``_head_stats``) takes the RAMP label
    as its step-``k`` token and goes dead for the rest of the window:
    later stages never count it (``stage_steps``), and once a microbatch
    is all dead its payload goes inert and the window can end early. With
    no thresholds no exit can fire and the tokens are those of plain
    greedy decode. A dead row of a live microbatch rides on with its last
    token, as in the reference.

    The loop is host-driven: each tick the host reads its payload's
    control words and the all-done flag (a sum over the stages), so a
    window makes one host read per tick, not one per window.

    tokens: (B, 1) int; pos: int (B,) per-row write indices; both whole
    on every rank. Returns ``(cache, tok_rec (n_steps, B), exit_rec
    (n_steps, B), alive (B,), stage_steps (S,))``: the stage's cache,
    ``exit_rec[k, b]`` the ramp-site index that fired for row ``b`` at step
    ``k`` (-1: none), ``tok_rec`` entries after a row's exit step garbage
    the caller masks (as ``decode_multi``'s records), ``stage_steps[s]``
    the alive-row x step work stage ``s`` ran. All but the cache are alike
    on every rank."""
    from repro_torch.distributed import all_gather_tiled, ring_shift, sum_over
    from repro_torch.models import layers as LY

    cfg, plan = model.cfg, model.plan
    S, sid, group = mesh.pp, mesh.stage, mesh.groups["stage"]
    B = int(tokens.shape[0])
    pipeline_check(model, S, batch=B)
    n_steps = int(n_steps)
    Bm = B // S
    Lp = plan.n_periods // S
    last = S - 1
    dev = tokens.device
    stage_model = _stage_model(model, S)

    # host-side ramp routing: stage s's boundary layer -> (site index, threshold)
    act = [] if active_sites is None else [int(a) for a in active_sites]
    thr_in = [0.0] * len(act) if thresholds is None else [float(t) for t in thresholds]
    site_of, thr_of = [0] * S, [0.0] * S  # 0.0 never fires (strict <)
    for s in range(S - 1):
        boundary = (s + 1) * Lp * len(plan.period) - 1
        for j, a in enumerate(act):
            if model.sites[a] == boundary:
                site_of[s], thr_of[s] = a, thr_in[j]

    pos = pos.reshape(-1).to(torch.int64)
    mb = (S - sid) % S  # payload j enters stage 0 at tick j
    ctl = [mb, 0, 0, int(n_steps <= 0)]  # mb, k, next stage, done
    nrec = max(n_steps, 1)
    pl = {"h": torch.zeros((Bm, 1, cfg.d_model), dtype=params["tok"]["embed"].dtype,
                           device=dev),
          "tok": tokens[mb * Bm:(mb + 1) * Bm].reshape(Bm, 1).to(torch.int64),
          "alive": torch.ones(Bm, dtype=torch.bool, device=dev),
          "tok_rec": torch.zeros((nrec, Bm), dtype=torch.int32, device=dev),
          "exit_rec": torch.full((nrec, Bm), -1, dtype=torch.int32, device=dev)}
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    Sc = cache["blocks"][0]["k"].shape[2]
    t, all_done = 0, False
    while t < n_steps * S + S and not all_done:
        mb, k, nxt, done = ctl
        if nxt == sid and not done:  # this stage works on its payload
            rows = slice(mb * Bm, (mb + 1) * Bm)
            pos_mb = pos[rows] + k
            pc = pos_mb[:, None]
            h = (LY.embed_apply(cfg, params["tok"], pl["tok"], pc).to(pl["h"].dtype)
                 if sid == 0 else pl["h"])
            mask = (torch.arange(Sc, device=dev)[None, :] <= pc)[:, None, None, :]
            cb = {"blocks": [tree_map(lambda x: x[:, rows], blk) for blk in cache["blocks"]]}
            h, _, _ = stage_model._stack(params, h, positions=pc, mask=mask, caches=cb,
                                         cache_index=pos_mb, pool_idx=slice(0, 1))
            steps += pl["alive"].sum()
            alive = pl["alive"]
            if act and sid != last and thr_of[sid] > 0.0:
                # the boundary ramp as the model's own head path computes it
                rlog = model.ramp_outputs(params, {model.sites[site_of[sid]]: h},
                                          [site_of[sid]], stop_grad=False)
                st = _stats(_mask_pad_vocab(cfg, rlog[0, :, 0]))
                rl, runc = st["label"], 1.0 - st["maxprob"]
                fire = alive & (runc < thr_of[sid])
                pl["tok_rec"][k] = torch.where(fire, rl, pl["tok_rec"][k])
                pl["exit_rec"][k] = torch.where(fire, site_of[sid], pl["exit_rec"][k])
                alive = alive & ~fire
            if sid == last:
                fl = model._head_stats(params, h, None, None)["final"]["label"]
                pl["tok_rec"][k] = torch.where(alive, fl, pl["tok_rec"][k])
                pl["tok"] = torch.where(alive[:, None], fl[:, None].to(torch.int64), pl["tok"])
                k += 1
                done = int(k >= n_steps or not bool(alive.any()))
            pl["h"], pl["alive"] = h.to(pl["h"].dtype), alive
            ctl = [mb, k, 0 if sid == last else sid + 1, done]
        names = list(pl)
        moved = ring_shift([torch.tensor(ctl, dtype=torch.int64, device=dev)]
                           + [pl[n] for n in names], group)
        ctl = moved[0].tolist()  # the host's read of its new payload
        pl = dict(zip(names, moved[1:]))
        all_done = int(sum_over(moved[0][3:], group).item()) >= S
        t += 1

    # each microbatch's rows live in exactly one payload: gather them all
    order = all_gather_tiled(torch.tensor([ctl[0]], device=dev), group, 0).tolist()
    inv = sorted(range(S), key=lambda r: order[r])

    def collect(x):
        allx = all_gather_tiled(x[None], group, 0)
        return torch.cat([allx[r] for r in inv], dim=-1)

    tok_rec, exit_rec = collect(pl["tok_rec"]), collect(pl["exit_rec"])
    alive = collect(pl["alive"])
    stage_steps = all_gather_tiled(steps.reshape(1), group, 0)
    return cache, tok_rec[:n_steps], exit_rec[:n_steps], alive, stage_steps
