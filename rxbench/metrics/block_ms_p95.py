"""block_ms_p95: the 95th percentile over all blocks of the window of the
time from handing a block to the entry until both of its audio planes are
in the page-locked host buffers (statistics.quantiles, exclusive method)."""

import statistics


def read(ctx):
    blocks = ctx["block_s"]
    if len(blocks) < 20:
        return None
    return statistics.quantiles(blocks, n=20)[18] * 1e3
