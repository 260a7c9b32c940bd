"""tpot_p95_ms: the 95th percentile, over every request whose first and
last tokens both came inside the window, of (its last token's time - its
first's) / (tokens - 1). A token's time is the end of the runner call that
returned it, on the host clock."""
from bench.harness import percentile


def read(ctx):
    v = [1e3 * (r["t_last"] - r["t_first"]) / (r["n"] - 1) for r in ctx.done if r["n"] > 1]
    return percentile(v, 95) if v else None
