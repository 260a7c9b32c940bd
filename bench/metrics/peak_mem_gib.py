"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` from the start of the
process to the close of the window, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30
