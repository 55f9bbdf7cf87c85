"""product_roofline.cold: ``product_roofline`` in the cells whose
products are planned cold, where it moves ``cold_gflops``."""
from opbench.harness import load_reader


def read(ctx):
    return load_reader(ctx.cell.root, "product_roofline")(ctx)
