"""copy_ms: device time of the host-device copies (HtoD uploads, DtoH
readbacks) a call: their total over the traced window over its calls
(profiler). Reads copy_ms.live."""


def read(ctx):
    events = ctx["trace"]
    if events is None or not events["calls"]:
        return None
    copies = [e - s for s, e, name in events["device"]
              if name.startswith(("Memcpy HtoD", "Memcpy DtoH"))]
    return sum(copies) * 1e-3 / events["calls"] if copies else None
