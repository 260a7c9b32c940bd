"""The plain decoder the benchmark's references share: a whole forward
pass in float32 (TF32 off), no cache, no batching, no kernel.

It reads the configuration file's sizes (``shapes.arch``) and the weights
the benchmark drew (``weights.draw``), in the program's layout: the layer
leaves of ``blocks[0]`` stacked over the layers (after the unstacked
``prefix`` layers), norm gains stored as ``1 + w``, the ramps' gains and
heads stacked over the sites. Each family's module beside this one
(``<model_type>.py``, found by the file's ``model_type``) names what is
its own; the equations here are the published ones:

- attention: GQA, q/k/v biases where the family has them
  (``arch["qkv_bias"]``), RoPE (rotate-half pairs, ``theta``);
- latent attention (MLA, where the file has ``kv_lora_rank``): queries
  without a low-rank path, the latent ``c`` normed, keys and values
  expanded from it, a shared RoPE key of ``dr``;
- a SwiGLU FFN; or, past ``first_k_dense_replace`` layers where the file
  has ``n_routed_experts``, a MoE (a softmax router, the top-k experts by a
  stable sort, their gates renormalised where ``norm_topk``, shared
  experts beside them).

Departures of the program from the published models are the file's
(``assumed``, and ``as_run`` for the keys the arithmetic follows). Each
ramp site's head reads the site layer's output through its own RMSNorm.

``precision='fp8'`` is the control: every product takes both operands
through float8 e4m3 (a scale a row of activations, a scale an output
column of weights) and sums in float32; the rest is as above.
``precision='bf16'`` is a witness of what bfloat16 alone does: every
product in bfloat16 (float32 sums), the rest in float32.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch

F8_MAX = 448.0  # the largest float8 e4m3 value


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` through float8 e4m3, one scale along ``dim``'s slices."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, pos, theta):
    """x (T, n, dim) rotated at positions ``pos`` (T,): pairs (i, i + dim/2)."""
    dim = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=x.device) / dim))
    ang = pos.float()[:, None] * freqs
    s, c = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., : dim // 2], x[..., dim // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def causal_attention(q, k, v, scale, block=512):
    """q (T, H, dq), k (T, KH, dq), v (T, KH, dv): each query attends the
    keys at or before it; heads share a key head in groups of H / KH."""
    T, H, _ = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    out = torch.empty(T, H, v.shape[-1], dtype=torch.float32, device=q.device)
    keys = torch.arange(T, device=q.device)
    for a in range(0, T, block):
        b = min(T, a + block)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
        s = s.masked_fill(keys[None, None, :b] > keys[a:b, None][None], float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v[:b])
    return out


class Decoder:
    """The model of ``arch`` over ``params``: ``hidden`` runs the layers,
    ``head`` and ``logits`` a head over their outputs."""

    def __init__(self, arch: dict, params: dict, precision: str = "f32"):
        if precision not in ("f32", "fp8", "bf16"):
            raise ValueError(f"precision {precision!r}: 'f32' | 'fp8' | 'bf16'")
        self.a, self.p, self.precision = arch, params, precision

    # -- products --------------------------------------------------------

    def _w(self, t: torch.Tensor) -> torch.Tensor:
        """A weight (..., in, out) as the products take it."""
        if self.precision == "bf16":
            return t.to(torch.bfloat16)
        t = t.float()
        return _q8(t, -2) if self.precision == "fp8" else t

    def _mm(self, x, w):
        if self.precision == "bf16":
            return (x.to(torch.bfloat16) @ w).float()
        return (_q8(x, -1) if self.precision == "fp8" else x) @ w

    # -- layers ----------------------------------------------------------

    def _layer_params(self, i: int) -> dict:
        """Layer ``i``'s leaves in float32, the products' weights as
        ``_w`` takes them (the f32 router as it is)."""
        k = self.a["first_dense"] if self.a["moe"] else 0
        p = self.p["prefix"][i] if i < k else _map(lambda t: t[i - k], self.p["blocks"][0])

        def prep(node, name=""):
            if isinstance(node, dict):
                return {k: prep(v, k) for k, v in node.items()}
            return self._w(node) if node.dim() >= 2 and name != "router" else node.float()

        return prep(p)

    def _attn(self, p, x, pos):
        a = self.a
        T = x.shape[0]
        H, KH, hd = a["H"], a["KH"], a["hd"]
        q, k, v = (self._mm(x, p[n]) for n in ("wq", "wk", "wv"))
        if a["qkv_bias"]:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q = rope(q.view(T, H, hd), pos, a["theta"])
        k = rope(k.view(T, KH, hd), pos, a["theta"])
        o = causal_attention(q, k, v.view(T, KH, hd), 1.0 / math.sqrt(hd))
        return self._mm(o.reshape(T, H * hd), p["wo"])

    def _mla(self, p, x, pos):
        a = self.a
        T = x.shape[0]
        H, r, dn, dr, dv = a["H"], a["r"], a["dn"], a["dr"], a["dv"]
        q = self._mm(x, p["wq"]).view(T, H, dn + dr)
        ckv = self._mm(x, p["w_dkv"])
        c = rms_norm(ckv[:, :r], p["kv_norm"], a["eps"])
        k_pe = rope(ckv[:, None, r:], pos, a["theta"])  # one head, shared
        q_pe = rope(q[..., dn:], pos, a["theta"])
        k_nope = self._mm(c, p["w_uk"]).view(T, H, dn)
        v = self._mm(c, p["w_uv"]).view(T, H, dv)
        k = torch.cat([k_nope, k_pe.expand(T, H, dr)], dim=-1)
        o = causal_attention(torch.cat([q[..., :dn], q_pe], dim=-1), k, v,
                             1.0 / math.sqrt(dn + dr))
        return self._mm(o.reshape(T, H * dv), p["wo"])

    def _swiglu(self, p, x):
        h = torch.nn.functional.silu(self._mm(x, p["w_gate"])) * self._mm(x, p["w_up"])
        return self._mm(h, p["w_down"])

    def _moe(self, p, x):
        a = self.a
        probs = torch.softmax(x @ p["router"], dim=-1)
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[:, :a["top_k"]], idx[:, :a["top_k"]]
        if a["norm_topk"]:
            gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        gates = gates * a["routed_scale"]
        y = torch.zeros_like(x)
        for e in torch.unique(idx).tolist():
            tok, slot = (idx == e).nonzero(as_tuple=True)
            w = {n: p[n][e] for n in ("w_gate", "w_up", "w_down")}
            y.index_add_(0, tok, gates[tok, slot][:, None] * self._swiglu(w, x[tok]))
        if a["n_shared"]:
            y = y + self._swiglu(p["shared"], x)
        return y

    def hidden(self, seqs: Sequence[torch.Tensor], sites: Sequence[int]) -> List[dict]:
        """The final head's input (the last layer's output through the final
        norm) and each ramp site's head input, (T, d) float32, for each
        token sequence of ``seqs``. Layer-major: each layer's weights go to
        float32 once for every sequence."""
        a = self.a
        embed = self.p["tok"]["embed"]
        hs = [embed[s].float() for s in seqs]
        pos = [torch.arange(len(s), device=s.device) for s in seqs]
        out = [{"ramps": {}} for _ in seqs]
        site_of = {layer: i for i, layer in enumerate(a["sites"])}
        for layer in range(a["L"]):
            p = self._layer_params(layer)
            mixer = self._mla if a["mla"] else self._attn
            moe = a["moe"] and layer >= a["first_dense"]
            for n, h in enumerate(hs):
                x = rms_norm(h, p["ln1"]["w"], a["eps"])
                h = h + mixer(p["mixer"], x, pos[n])
                x = rms_norm(h, p["ln2"]["w"], a["eps"])
                h = h + (self._moe(p["ffn"], x) if moe else self._swiglu(p["ffn"], x))
                hs[n] = h
                i = site_of.get(layer)
                if i is not None and i in sites:
                    out[n]["ramps"][i] = rms_norm(
                        h, self.p["ramps"]["norm_w"][i].float(), a["eps"])
        for n, h in enumerate(hs):
            out[n]["final"] = rms_norm(h, self.p["final_norm"]["w"].float(), a["eps"])
        return out

    def head(self, site: int = None) -> torch.Tensor:
        """The (d, V) head over the real vocabulary: the final head
        (``site`` None) or ramp site ``site``'s."""
        V = self.a["V"]
        if site is not None:
            return self._w(self.p["ramps"]["head"][site][:, :V])
        tok = self.p["tok"]
        return self._w(tok["embed"][:V].T if self.a["tie"] else tok["lm_head"][:, :V])

    def logits(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self._mm(h, w)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)
