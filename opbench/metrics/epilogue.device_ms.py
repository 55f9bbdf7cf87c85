"""epilogue.device_ms: device ms a traced product launched inside the
profiler range ``hash_epilogue`` (the sort and condense of the hash
tables into C)."""


def read(ctx):
    t = ctx.trace
    if t is None or "hash_epilogue" not in t.range_device_s:
        return None
    return t.range_device_s["hash_epilogue"] * 1e3 / t.products
