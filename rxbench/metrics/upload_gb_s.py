"""upload_gb_s: the bytes the port's ``rdsp.upload`` spans carried from the
host (their ``bytes``) over those spans' time, in the traced window.
Reads upload_gb_s.live."""

from rxbench import program_spans


def read(ctx):
    got = program_spans.session(ctx)
    if got is None:
        return None
    ups = [s for s in got.spans if s.name == "rdsp.upload"]
    moved = sum(s.attrs.get("bytes", 0) for s in ups)
    took_ns = sum(s.end_ns - s.start_ns for s in ups)
    return moved / took_ns if moved and took_ns > 0 else None
