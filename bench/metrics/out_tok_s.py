"""out_tok_s: output tokens released inside the window (each request's
prefill token and every decode token, as the runner's calls returned them)
over the window's seconds, on the host clock."""


def read(ctx):
    return sum(c["tokens"] for c in ctx.calls) / (ctx.t_close - ctx.t_open)
