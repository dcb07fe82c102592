"""engine.host_pct.serve: the share of the engine's time spent in its two
phases that never wait on the card, engine.plan and engine.results, of the
four spans that cover search_many (plan, launch, readback, results), as
/healthz `phases` totals them, their differences over the window.  None
where the service reports no phases."""


def read(ctx):
    if ctx.health is None:
        return None
    h0, h1, _ = ctx.health
    if "phases" not in h1:
        return None
    d = {k: v - h0["phases"][k] for k, v in h1["phases"].items()}
    whole = sum(d.values())
    return 100.0 * (d["engine.plan"] + d["engine.results"]) / whole \
        if whole > 0 else None
