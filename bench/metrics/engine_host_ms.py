"""engine_host_ms: host ms between the runner's calls (the engine and the
controller: admission, the records replayed, the ramps adjusted), summed
over the window's consecutive calls made while no profiler ran, over the
windows among them."""


def read(ctx):
    ids = {c["id"] for c in ctx.plain}
    gaps = [b["t0"] - a["t1"] for a, b in zip(ctx.calls, ctx.calls[1:])
            if a["id"] in ids and b["id"] in ids]
    windows = sum(1 for c in ctx.plain if c["kind"] == "step")
    return 1e3 * sum(gaps) / windows if windows else None
