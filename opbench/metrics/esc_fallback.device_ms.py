"""esc_fallback.device_ms: device ms a traced product launched inside the
profiler range ``hash_fallback`` (the ESC rung of the rows too large for
the top hash table)."""


def read(ctx):
    t = ctx.trace
    if t is None or "hash_fallback" not in t.range_device_s:
        return None
    return t.range_device_s["hash_fallback"] * 1e3 / t.products
