"""chain_host_ms: the port's ``rdsp.chain`` span a call of the traced
window: the chain wrapper's host time (its checks, output allocation and
launch; no wait for the card). Reads chain_host_ms.seg and
chain_host_ms.live alike."""

from rxbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, "rdsp.chain")
