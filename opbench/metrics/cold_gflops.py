"""cold_gflops: ``gflops`` of the cells whose products are planned cold,
under a name of its own: a cold product waits on the host between its
steps, so its rate spreads more from run to run and takes its own
bound."""


def read(ctx):
    return ctx.values["gflops"]
