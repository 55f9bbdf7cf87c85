"""hash_kernels_roofline: the least time of the product's hash-table
work over the device time a traced product spends in the kernels of
``kernels/csrc/spgemm_hash.cu``, in %.

The work is the rows that the hash tables take (1 to ``max_nprod``
products; the rest go to the fallback rung), counted by
``counts.table_rows_work`` from A's structure and C's row sizes as the
reference found them: each input byte those rows need read once, each
output byte written once.  ``max_nprod`` is the configuration's
``table_rows_max_nprod``."""

KERNELS = (r"\b(hash_rows_kernel|slot_rows_kernel|cluster_rows_kernel"
           r"|global_rows_kernel)\b")


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    device_s = ctx.trace.device_s_matching(KERNELS) / ctx.trace.products
    if device_s <= 0:
        return None
    least, bound = ctx.work["table_rows"].least_s(ctx.peaks, ctx.dtype)
    ctx.extra[ctx.metric] = {
        "bound": bound, "least_ms": least * 1e3,
        "kernels_ms": device_s * 1e3, "power_limit": ctx.power}
    return 100.0 * least / device_s
