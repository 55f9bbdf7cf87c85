"""hash_kernels_roofline.cold: ``hash_kernels_roofline`` in the cells whose
products are planned cold, where it moves ``cold_gflops``."""
from opbench.harness import load_reader


def read(ctx):
    return load_reader(ctx.cell.root, "hash_kernels_roofline")(ctx)
