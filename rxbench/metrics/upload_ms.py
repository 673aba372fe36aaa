"""upload_ms: the port's ``rdsp.upload`` span (``models/fused._planar``: the
input planes to the card, waiting for the copy from page-locked host
memory) a call of the traced window, host time on the profiler's clock.
Reads upload_ms.live."""

from rxbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, "rdsp.upload")
