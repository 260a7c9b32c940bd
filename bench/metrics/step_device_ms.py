"""step_device_ms: device-busy ms inside the traced stretch's windows (the
union of the device operations' intervals inside each ``step_multi`` call)
over the decode steps those windows ran."""
from bench import tracing


def read(ctx):
    st = ctx.stretch
    if st is None:
        return None
    steps = sum(c["n"] for c in st.calls if c["kind"] == "step")
    ns = tracing.in_calls_ns(st, "step")
    return ns / 1e6 / steps if steps and ns else None
