"""state_ms: the port's ``rdsp.state`` span (the next state: the DDS phase,
the input tail, the carries' padding) a call of the traced window. Reads
state_ms.seg and state_ms.live alike."""

from rxbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, "rdsp.state")
