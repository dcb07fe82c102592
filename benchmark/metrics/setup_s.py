"""setup_s: from handing the corpus to the port until it takes traffic:
packing, the engine and its copy of the database, the kernel libraries
(built, on a checkout's first run, else loaded from the checkout's
kernel directory), the engine's warmup, the benchmark's warm-up batch or
requests and, in the serve mixes, the server's start."""


def read(ctx):
    return ctx.setup_s
