"""epilogue.device_ms.cold: ``epilogue.device_ms`` in the cells whose
products are planned cold, where it moves ``cold_gflops``."""
from opbench.harness import load_reader


def read(ctx):
    return load_reader(ctx.cell.root, "epilogue.device_ms")(ctx)
