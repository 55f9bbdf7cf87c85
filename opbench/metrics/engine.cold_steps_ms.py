"""engine.cold_steps_ms: host ms a product in the engine's ``cold_steps``
span (the six-step flow of a cold plan, waiting at each step), from the
telemetry of the engines the window made."""


def read(ctx):
    durs = [s["dur"] for s in ctx.window.spans if s["name"] == "cold_steps"]
    if not durs:
        return None
    return sum(durs) * 1e3 / ctx.products
