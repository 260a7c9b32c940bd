"""attn_roofline: the port's attention kernels in the traced stretch
(#4 flash prefill, #5 paged decode, #6 paged MLA decode), their summed
bound time (``roofline.py``: each layer's call at the shapes the stretch's
calls ran, only the positions attended) over their summed device time."""
from bench import tracing


def read(ctx):
    st, rl, a = ctx.stretch, ctx.roofline, ctx.arch
    if st is None:
        return None
    ns = tracing.kernel_ns(st, tracing.ATTENTION)
    if not ns:
        return None
    bs = int(ctx.settings["kv_block_size"])
    bound = 0.0
    for c in st.calls:
        if c["kind"] == "start" and not a["mla"]:  # MLA prefills attend without a kernel
            bound += a["L"] * rl.bound_s(*rl.prefill_attn(a, 1, c["S"]))
        elif c["kind"] == "step":
            for t in range(c["n"]):
                bound += a["L"] * rl.bound_s(*rl.decode_attn(a, [p + t for p in c["pos0"]], bs))
    return 100.0 * bound / (ns / 1e9)
