"""esc_fallback.device_ms.cold: ``esc_fallback.device_ms`` in the cells whose
products are planned cold, where it moves ``cold_gflops``."""
from opbench.harness import load_reader


def read(ctx):
    return load_reader(ctx.cell.root, "esc_fallback.device_ms")(ctx)
