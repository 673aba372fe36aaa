"""msamples_per_s: IQ samples (channels x samples) whose audio the window
completed, over the whole window, which ends at the final synchronize."""


def read(ctx):
    return ctx["calls"] * ctx["samples_per_call"] / ctx["window_s"] / 1e6
