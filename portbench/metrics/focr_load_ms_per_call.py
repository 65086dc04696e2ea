"""What a focr call spends outside its decode (argument parsing, bank load,
page reads, printing): each traced call's time less its --metrics-json
decode_seconds, the mean over the calls."""


def read(ctx):
    parts = [c["seconds"] - c["metrics"]["decode_seconds"] for c in ctx.calls if "metrics" in c]
    if len(parts) != len(ctx.calls):
        return None
    return 1e3 * sum(parts) / len(parts)
