"""peak_mem_gib: the device memory that torch's allocator held at its
peak over set-up and the window (``torch.cuda.max_memory_allocated``),
GiB: what bounds the group a card can train (``parallel.batch.group_cap``)."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
