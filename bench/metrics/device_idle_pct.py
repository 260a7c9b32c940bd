"""device_idle_pct: the share of the traced stretch's wall time in which no
operation ran on the device."""
from bench import tracing


def read(ctx):
    st = ctx.stretch
    if st is None or st.t1_ns <= st.t0_ns:
        return None
    busy = tracing.busy_ns(st)
    return 100.0 * (1.0 - busy / (st.t1_ns - st.t0_ns)) if busy else None
