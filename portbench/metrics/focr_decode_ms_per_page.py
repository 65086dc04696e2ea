"""focr's grid decoder (crop, upload, K4, assembly): the CLI's own
--metrics-json decode_seconds of the traced calls, over their pages."""


def read(ctx):
    secs = [c["metrics"]["decode_seconds"] for c in ctx.calls if "metrics" in c]
    if len(secs) != len(ctx.calls):
        return None
    return 1e3 * sum(secs) / sum(len(c["doc"]) for c in ctx.calls)
