"""cold_product_ms_p90: ``product_ms_p90`` of the cells whose products
are planned cold, under a name of its own and with its own bound (see
``cold_gflops``)."""


def read(ctx):
    return ctx.values["product_ms_p90"]
