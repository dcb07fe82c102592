"""engine.host_pct (and its splits, `engine.host_pct.<part>`, but for
`.serve`, which has its own reader): the share of the engine's time spent
in its two phases that never wait on the card, engine.plan and
engine.results, of the four spans that cover search_many (plan, launch,
readback, results), from the port's process-wide totals
(`oswald_tpu_torch.utils.metrics.process_metrics()`).  Those total every
search_many of the run: the engine's warmup batch and the mix's warm-up
batch as well as the window's batches, traced or not.  A batch mix only;
None where the program keeps no such totals."""


def read(ctx):
    if ctx.mode != "batch":
        return None
    try:
        from oswald_tpu_torch.utils.metrics import process_metrics
    except ImportError:
        return None
    m = process_metrics()
    t = {n: m.total(n) for n in ("engine.plan", "engine.launch",
                                 "engine.readback", "engine.results")}
    whole = sum(t.values())
    return 100.0 * (t["engine.plan"] + t["engine.results"]) / whole \
        if whole > 0 else None
