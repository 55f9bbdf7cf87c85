"""product_roofline: the whole product's least time over the mean time of
the window's products (host clock), in %.  The least time is the larger of
A's, B's and C's CSR bytes, each read or written once, over the card's
bandwidth, and 2 n_prod operations over its peak rate in the operand's
type (``counts.product_work``); whatever kernels a product runs, it
cannot beat it."""


def read(ctx):
    if ctx.peaks is None or ctx.products == 0:
        return None
    per_product = sum(ctx.window.latencies_s) / ctx.products
    least, bound = ctx.work["product"].least_s(ctx.peaks, ctx.dtype)
    ctx.extra[ctx.metric] = {
        "bound": bound, "least_ms": least * 1e3,
        "product_ms": per_product * 1e3, "power_limit": ctx.power}
    return 100.0 * least / per_product
