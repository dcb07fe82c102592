"""serve.queries_per_dispatch: queries over engine dispatches (calls of
search_many by the service's drain thread), both as /healthz counts them,
their differences over the window."""


def read(ctx):
    if ctx.health is None:
        return None
    h0, h1, _ = ctx.health
    d = h1["dispatches"] - h0["dispatches"]
    return (h1["queries"] - h0["queries"]) / d if d > 0 else None
