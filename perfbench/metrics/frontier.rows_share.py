"""Share of tile rows the active frontier swept, in percent: gathered rows
over what always-full sweeps would have gathered, summed over the traced
window (``DecomposeResult.gathered_rows`` / ``full_sweep_rows``)."""


def read(ctx):
    full = sum(r.full_sweep_rows for r in ctx.results)
    if full == 0:
        return None
    return 100.0 * sum(r.gathered_rows for r in ctx.results) / full
