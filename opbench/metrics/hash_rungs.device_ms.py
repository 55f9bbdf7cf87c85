"""hash_rungs.device_ms: device ms a traced product launched inside the
profiler range ``hash_rungs`` (the hash-table rungs: the fused or the
symbolic and numeric kernels, their row ids, masks, n_nz scatters and
output fills)."""


def read(ctx):
    t = ctx.trace
    if t is None or "hash_rungs" not in t.range_device_s:
        return None
    return t.range_device_s["hash_rungs"] * 1e3 / t.products
