"""launch_ms: the port's ``rdsp.launch`` spans (a wrapper's call into its
kernel library) a call of the traced window. Reads launch_ms.live."""

import sys

from rxbench import program_spans


def read(ctx):
    got = program_spans.session(ctx)
    if got is not None:
        print(f"launch_ms: {program_spans.count(got, 'rdsp.launch')} rdsp.launch spans in "
              f"{ctx['trace']['calls']} calls", file=sys.stderr)
    return program_spans.per_call_ms(ctx, "rdsp.launch")
