"""hash_rungs.device_ms.cold: ``hash_rungs.device_ms`` in the cells whose
products are planned cold, where it moves ``cold_gflops``."""
from opbench.harness import load_reader


def read(ctx):
    return load_reader(ctx.cell.root, "hash_rungs.device_ms")(ctx)
