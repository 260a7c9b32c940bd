"""A configuration file's sizes, read into the names the benchmark's
arithmetic and its plain reference use.

A configuration file holds the model's published ``config.json`` keys
(Hugging Face names) as published, a ``ramps`` block (Apparate's early-exit
heads, which no published config has) and, where the program's arithmetic
departs from a published key, an ``as_run`` block with that key as the
program runs it (each departure explained under ``assumed``). ``arch``
maps them to short names, the ``as_run`` values over the published ones;
a key the family does not have reads as absent, never guessed, and what
the family fixes beyond its config comes from its reference module.
"""
from __future__ import annotations

import math
from typing import Tuple

from bench.reference import family


def ramp_sites(n_layers: int, max_sites: int = 12) -> Tuple[int, ...]:
    """The layers after which a ramp head may sit: block boundaries thinned
    to at most ``max_sites``, never the last layer."""
    n = min(n_layers - 1, max_sites)
    if n <= 0:
        return ()
    stride = (n_layers - 1) / n
    sites = sorted({int(math.floor((i + 1) * stride)) - 1 for i in range(n)})
    return tuple(s for s in sites if 0 <= s < n_layers - 1) or (0,)


def arch(c: dict) -> dict:
    """The sizes of configuration file ``c``, as the program runs them."""
    c = {**c, **c.get("as_run", {})}
    if c.get("rope_scaling"):
        raise ValueError("rope scaling is not in the reference: state the program's "
                         "departure under as_run")
    d, H = c["hidden_size"], c["num_attention_heads"]
    a = {
        "family": c["model_type"],
        "L": c["num_hidden_layers"], "d": d, "H": H,
        "KH": c.get("num_key_value_heads", H),
        "hd": c.get("head_dim") or d // H,
        "d_ff": c["intermediate_size"], "V": c["vocab_size"],
        "theta": float(c["rope_theta"]), "eps": float(c["rms_norm_eps"]),
        "tie": bool(c.get("tie_word_embeddings", False)),
        "mla": "kv_lora_rank" in c, "moe": "n_routed_experts" in c,
    }
    if a["mla"]:
        if c.get("q_lora_rank"):
            raise ValueError("a low-rank query (q_lora_rank) is not in the reference")
        a.update(r=c["kv_lora_rank"], dn=c["qk_nope_head_dim"], dr=c["qk_rope_head_dim"],
                 dv=c["v_head_dim"])
    if a["moe"]:
        a.update(E=c["n_routed_experts"], top_k=c["num_experts_per_tok"],
                 n_shared=c.get("n_shared_experts") or 0, ff=c["moe_intermediate_size"],
                 first_dense=c.get("first_k_dense_replace", 0),
                 norm_topk=bool(c.get("norm_topk_prob", False)),
                 routed_scale=float(c.get("routed_scaling_factor", 1.0)))
    a.update(family(c["model_type"]).traits(c))
    r = c["ramps"]
    a["sites"] = ramp_sites(a["L"], r["max_sites"])
    return a
