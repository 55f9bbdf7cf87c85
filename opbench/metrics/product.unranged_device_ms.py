"""product.unranged_device_ms: device ms a traced product spends in
operations that no range of the product's partition launched: the
device time of every kernel, copy and fill of the product less the
device time of the ranges of ``PARTITION`` and of the host reads
(``sync:*``, ``step_wait:*``), which do not nest.  Near 0 when every
device operation of a product has a name; ``extra`` gives each range's
device ms a product.  Nothing to read where the program has no
partition (no ``hash_setup``, ``hash_binning``, ``hash_rungs`` or
``hash_alloc`` range in the trace)."""

PARTITION = ("hash_setup", "hash_binning", "hash_rungs", "hash_fallback",
             "hash_alloc", "hash_epilogue", "operand_pad", "verify_sync")
READS = ("sync:", "step_wait:")
ALWAYS = ("hash_setup", "hash_binning", "hash_rungs", "hash_alloc")


def read(ctx):
    t = ctx.trace
    if t is None or not t.products or any(
            name not in t.range_device_s for name in ALWAYS):
        return None
    ranged = {name: s * 1e3 / t.products
              for name, s in sorted(t.range_device_s.items())
              if name in PARTITION or name.startswith(READS)}
    device_ms = sum(t.op_device_s.values()) * 1e3 / t.products
    ctx.extra[ctx.metric] = {"device_ms": device_ms, "ranges_ms": ranged}
    return device_ms - sum(ranged.values())
