"""ramp_roofline: the ramp-head kernels in the traced stretch (#2, the
final head's stats, once a prefill and once a decode step; #3, each active
ramp's stats and exit bit, once a decode step), their summed bound time
(``roofline.ramp_head``: the head read once a call over the real
vocabulary, the rows, the stats written) over their summed device time."""
from bench import tracing


def read(ctx):
    st, rl, a = ctx.stretch, ctx.roofline, ctx.arch
    if st is None:
        return None
    ns = tracing.kernel_ns(st, tracing.RAMP_HEAD)
    if not ns:
        return None
    bound = 0.0
    for c in st.calls:
        if c["kind"] == "start":
            bound += rl.bound_s(*rl.ramp_head(a, 1))
        elif c["kind"] == "step":
            B = len(c["pos0"])
            per = rl.bound_s(*rl.ramp_head(a, B)) \
                + len(c["act"]) * rl.bound_s(*rl.ramp_head(a, B, exit_out=True))
            bound += c["n"] * per
    return 100.0 * bound / (ns / 1e9)
