"""window_ms: the mean host ms of the window's ``step_multi`` calls made
while no profiler ran (a sync window: replayed, captured or eager), each
ending in the host read of its records."""


def read(ctx):
    t = [c["t1"] - c["t0"] for c in ctx.plain if c["kind"] == "step"]
    return 1e3 * sum(t) / len(t) if t else None
