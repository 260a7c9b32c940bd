"""prefill_ms: the mean host ms of the window's ``start`` calls made while
no profiler ran (a whole-prompt prefill, ending in the host read of its
first token)."""


def read(ctx):
    t = [c["t1"] - c["t0"] for c in ctx.plain if c["kind"] == "start"]
    return 1e3 * sum(t) / len(t) if t else None
