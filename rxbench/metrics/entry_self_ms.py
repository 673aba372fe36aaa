"""entry_self_ms: the self time of the port's ``rdsp.entry`` span (its
duration less its children's: the building of the chain's arguments) a
call of the traced window. Reads entry_self_ms.seg and entry_self_ms.live
alike."""

from rxbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, "rdsp.entry", self_time=True)
