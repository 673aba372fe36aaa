"""The comparison that decides ``correct``.

Once the window has closed, the reference recomputes the sampled pass's
capture from its start (``init_state()``, then the capture's calls one by
one) and every call of the pass, its outputs and its threaded state, is
held against it. What is compared is the configuration's: its ``compare``
names each number, the outputs and state keys it reads, and how:

  joint  max |got - ref| over the keys together / max |ref| over them
  each   the largest over the keys of max |got - ref| / max |ref|, each key
         on its own
  exact  the entries that differ, over the keys

and ``reference_own`` names, with the reason, each key of the reference's
state that no number reads (the reference's own carry, which the program
keeps in another form). A key the reference gives and the configuration
names in neither is an error: no carry drops out of ``correct`` unseen. A
key the program does not give, or gives in another shape, reads 1e30, as
does a non-finite reading: above every limit. The cell's file gives each
number's limit.
"""

from __future__ import annotations

import math

import torch

_FAIL = 1.0e30


def _joint(pairs) -> float:
    err = max((g.to(w.device).double() - w.double()).abs().max().item() for g, w in pairs)
    scale = max(w.double().abs().max().item() for _, w in pairs)
    value = err / scale if scale > 0 else err
    return value if math.isfinite(value) else _FAIL


def _each(pairs) -> float:
    return max(_joint([p]) for p in pairs)


def _exact(pairs) -> float:
    return float(sum(int((g.to(w.device) != w).sum()) for g, w in pairs))


HOW = {"joint": _joint, "each": _each, "exact": _exact}


def tensors(d: dict) -> dict:
    return {k: v for k, v in d.items() if torch.is_tensor(v)}


def unnamed(settings: dict, ref_out: dict, ref_state: dict) -> list:
    """The reference's outputs and state keys that no number reads and that
    the configuration does not name as the reference's own."""
    named = set(settings.get("reference_own", {}))
    for g in settings["compare"].values():
        named |= set(g.get("outputs", [])) | set(g.get("state", []))
    return sorted((set(ref_out) | set(tensors(ref_state))) - named)


def numbers(out: dict, view: dict, ref_out: dict, ref_state: dict, settings: dict) -> dict:
    """The readings of one compared call."""
    loose = unnamed(settings, ref_out, ref_state)
    if loose:
        raise ValueError(f"the reference carries {loose}, which the configuration's compare "
                         "neither reads nor names under reference_own")
    nums = {}
    for name, g in settings["compare"].items():
        pairs = [(out.get(k), ref_out.get(k)) for k in g.get("outputs", [])]
        pairs += [(view.get(k), ref_state.get(k)) for k in g.get("state", [])]
        if not pairs or any(a is None or b is None or tuple(a.shape) != tuple(b.shape)
                            for a, b in pairs):
            nums[name] = _FAIL
        else:
            nums[name] = HOW[g["how"]](pairs)
    return nums


def capture(planes, j: int):
    """Capture j of the pool, (C, n) per plane."""
    return [p[j].transpose(0, 1).reshape(p.shape[2], -1) for p in planes]


def compare(ref, planes, kept, span: int, settings: dict, limits: dict):
    """Every kept call against the reference: ({number: {"value": the worst
    reading, "limit"}}, how many kept calls exceeded a limit). ``kept`` is
    one pass through a capture, its calls in order from the first."""
    if set(limits) != set(settings["compare"]):
        raise ValueError(f"the cell's limits {sorted(limits)} are not the configuration's "
                         f"numbers {sorted(settings['compare'])}")
    if not kept:
        return {k: {"value": _FAIL, "limit": limits[k]} for k in limits}, 1
    worst = dict.fromkeys(limits, 0.0)
    failed = 0
    j = kept[0][0]
    xr, xi = (x.to(ref.device) for x in capture(planes, j))
    state = ref.init_state()
    for pos, (cj, s, got, view) in enumerate(kept):
        if (cj, s) != (j, pos):
            raise ValueError(f"kept call {pos} is call {s} of capture {cj}, not of one pass")
        out, state = ref.process(xr[:, s * span:(s + 1) * span], xi[:, s * span:(s + 1) * span],
                                 state)
        nums = numbers(got, view, out, state, settings)
        failed += any(not nums[k] <= limits[k] for k in limits)
        for k in limits:
            worst[k] = max(worst[k], nums[k])
        del out
    return {k: {"value": worst[k], "limit": limits[k]} for k in limits}, failed
