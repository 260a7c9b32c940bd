"""mfu_pct: the operations the traced stretch's tokens need
(``roofline.prefill_flops`` for each prefill, ``roofline.decode_flops``
for each decode step at its rows' positions and active ramps; a MoE
token's routed and shared experts, not every expert the dense dispatch
runs) over the stretch's seconds at the dense bf16 peak."""


def read(ctx):
    st, rl, a = ctx.stretch, ctx.roofline, ctx.arch
    if st is None or st.t1_ns <= st.t0_ns:
        return None
    flops = 0.0
    for c in st.calls:
        if c["kind"] == "start":
            flops += rl.prefill_flops(a, c["S"])
        elif c["kind"] == "step":
            for t in range(c["n"]):
                flops += rl.decode_flops(a, [p + t for p in c["pos0"]], len(c["act"]))
    return rl.mfu_share(flops, (st.t1_ns - st.t0_ns) / 1e9)
