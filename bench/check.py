"""How ``correct`` is decided: what the timed run served, held against the
plain reference of its family (``reference/<model_type>.py``) on the same prompts and the
program's own tokens.

Once the window has closed, a sample of the requests it finished, drawn
from the seed with the longest among them, goes through the reference in
float32: each prompt followed by the tokens the program served, one
forward pass. Three numbers come out, each the worst over the sample:

- ``final_gap``: by how much the reference's logit of a served token lies
  below the reference's best at that position (the prefill's token and
  every decode token; the program decodes greedily on the final head);
- ``ramp_gap``: the same for the label each active ramp head gave;
- ``ramp_maxprob_err``: the relative error of each active ramp head's
  max-probability against the reference's.

A stand-in puts the reference in the program's place at a lower
precision: ``fp8``, the control, or ``bf16``, a witness of what bfloat16
rounding alone gives. At the same positions it reads the f32 reference's
gap of the token the stand-in's heads put first, and the stand-in's
max-probabilities.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench import traffic
from bench.reference import family
from bench.reference.decoder import Decoder

NUMBERS = ("final_gap", "ramp_gap", "ramp_maxprob_err")  # each also as <name>_mean
ROWS = 512  # positions a head's logits are formed for at once


def sample(done: List[dict], seed: int, min_tokens: int) -> List[dict]:
    """The longest finished request, then others drawn from the seed until
    the sample holds ``min_tokens`` served tokens (or every request)."""
    if not done:
        return []
    done = sorted(done, key=lambda r: r["item"])
    first = max(done, key=lambda r: (len(r["tokens"]), -r["item"]))
    rest = [r for r in done if r is not first]
    order = traffic.rng(seed, "sample").permutation(len(rest))
    out, n = [first], len(first["tokens"])
    for i in order:
        if n >= min_tokens:
            break
        out.append(rest[i])
        n += len(rest[i]["tokens"])
    return out


def site_records(r: dict, site: int):
    """Request ``r``'s records of ramp site ``site``: the served tokens'
    indices, the labels and the max-probabilities, as arrays."""
    idx, lab, mp = [], [], []
    for j0, act, labels, maxprob in r["ramps"]:
        if site in act:
            k = act.index(site)
            idx.append(np.arange(j0, j0 + labels.shape[0]))
            lab.append(labels[:, k])
            mp.append(maxprob[:, k])
    if not idx:
        return None
    return np.concatenate(idx), np.concatenate(lab), np.concatenate(mp)


def _sites(reqs) -> list:
    return sorted({s for r in reqs for _, act, _, _ in r["ramps"] for s in act})


def _heads(ref: Decoder, hid: List[dict], reqs: List[dict], S: int, sites):
    """Per request, the logits' stats the numbers need: the final head at
    every served token's position, each ramp site's at its records'."""
    out = []
    w = ref.head()
    for h, r in zip(hid, reqs):
        n = len(r["tokens"])
        out.append({"final": _stats(ref, h["final"][S - 1:S - 1 + n], w,
                                    torch.as_tensor(r["tokens"], device=w.device))})
    for site in sites:
        w = ref.head(site)
        for h, r, o in zip(hid, reqs, out):
            rec = site_records(r, site)
            if rec is None:
                continue
            rows = torch.as_tensor(S - 1 + rec[0], device=w.device)
            lab = torch.as_tensor(rec[1], dtype=torch.int64, device=w.device)
            o[site] = _stats(ref, h["ramps"][site][rows], w, lab)
            o[site]["maxprob_prog"] = torch.as_tensor(rec[2], dtype=torch.float64)
    return out


def _stats(ref, h, w, pick):
    best, lse, top, at = [], [], [], []
    for a in range(0, h.shape[0], ROWS):
        lg = ref.logits(h[a:a + ROWS], w)
        best.append(lg.max(-1).values)
        lse.append(torch.logsumexp(lg, -1))
        top.append(lg.argmax(-1))
        at.append(lg.gather(1, pick[a:a + ROWS, None])[:, 0])
    cat = lambda xs: torch.cat(xs).double().cpu()  # noqa: E731
    return {"best": cat(best), "lse": cat(lse), "top": torch.cat(top), "at": cat(at)}


def compare(arch: dict, params: dict, prompts: np.ndarray, reqs: List[dict],
            stand_ins=()) -> Dict[str, dict]:
    """The numbers of the sample ``reqs`` (the recorder's request records:
    ``item``, ``tokens``, ``ramps``) against the float32 reference, and those of each
    stand-in precision of ``stand_ins`` ('fp8', 'bf16'). Returns
    {"program": numbers, <precision>: numbers, "counts": ...}."""
    dev = params["tok"]["embed"].device
    S = prompts.shape[1]
    seqs = [torch.as_tensor(np.concatenate([prompts[r["item"]], r["tokens"][:-1]]),
                            dtype=torch.int64, device=dev) for r in reqs]
    sites = _sites(reqs)
    Reference = family(arch["family"]).Reference
    ref = Reference(arch, params)
    hid = ref.hidden(seqs, sites)
    ref_stats = _heads(ref, hid, reqs, S, sites)
    out = {"program": _program_numbers(ref_stats, sites),
           "counts": {"requests": len(reqs), "tokens": sum(len(r["tokens"]) for r in reqs),
                      "ramp_records": sum(len(site_records(r, s)[0]) for r in reqs
                                          for s in sites if site_records(r, s) is not None)}}
    for precision in stand_ins:
        low = Reference(arch, params, precision=precision)
        low_stats = _heads(low, low.hidden(seqs, sites), reqs, S, sites)
        out[precision] = _stand_in_numbers(ref, hid, ref_stats, low_stats, reqs, S, sites)
    return out


def _summary(final_gaps, ramp_gaps, mp_errs) -> dict:
    """Each number of ``NUMBERS`` (the worst over the sample) and its mean
    over the sample (``<number>_mean``)."""
    out = {}
    for name, xs in zip(NUMBERS, (final_gaps, ramp_gaps, mp_errs)):
        x = torch.cat(xs) if xs else torch.zeros(1, dtype=torch.float64)
        out[name], out[name + "_mean"] = float(x.max()), float(x.mean())
    return out


def _program_numbers(stats, sites):
    fg = [s["final"]["best"] - s["final"]["at"] for s in stats]
    rg, re = [], []
    for site in sites:
        for s in stats:
            if site in s:
                x = s[site]
                rg.append(x["best"] - x["at"])
                mp = torch.exp(x["best"] - x["lse"])
                re.append((x["maxprob_prog"] - mp).abs() / mp)
    return _summary(fg, rg, re)


def _stand_in_numbers(ref, hid, ref_stats, low_stats, reqs, S, sites):
    """The f32 reference's gap at the tokens a stand-in's heads put first
    (``hid``: the f32 reference's head inputs), and the stand-in's
    max-probabilities' error."""
    fg, rg, re = [], [], []
    w = ref.head()
    for h, r, lo, rs in zip(hid, reqs, low_stats, ref_stats):
        n = len(r["tokens"])
        at = _stats(ref, h["final"][S - 1:S - 1 + n], w, lo["final"]["top"])["at"]
        fg.append(rs["final"]["best"] - at)
    for site in sites:
        w = ref.head(site)
        for h, r, lo, rs in zip(hid, reqs, low_stats, ref_stats):
            if site not in rs:
                continue
            rows = torch.as_tensor(S - 1 + site_records(r, site)[0], device=w.device)
            at = _stats(ref, h["ramps"][site][rows], w, lo[site]["top"])["at"]
            rg.append(rs[site]["best"] - at)
            mp_ref = torch.exp(rs[site]["best"] - rs[site]["lse"])
            mp_low = torch.exp(lo[site]["best"] - lo[site]["lse"])
            re.append((mp_low - mp_ref).abs() / mp_ref)
    return _summary(fg, rg, re)
