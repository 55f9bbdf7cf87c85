"""device.idle_share.cold: ``device.idle_share`` in the cells whose
products are planned cold, where it moves ``cold_gflops``."""
from opbench.harness import load_reader


def read(ctx):
    return load_reader(ctx.cell.root, "device.idle_share")(ctx)
