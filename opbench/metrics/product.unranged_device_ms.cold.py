"""product.unranged_device_ms.cold: ``product.unranged_device_ms`` in the
cells whose products are planned cold, where it moves ``cold_gflops``."""
from opbench.harness import load_reader


def read(ctx):
    return load_reader(ctx.cell.root, "product.unranged_device_ms")(ctx)
