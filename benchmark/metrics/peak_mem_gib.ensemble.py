"""peak_mem_gib.ensemble: torch.cuda.max_memory_allocated() over the
window, reset at its start, in GiB."""


def read(ctx):
    peak = ctx["window"].get("peak_bytes")
    return None if not peak else peak / 2.0 ** 30
