"""engine.replans: the shared engine's re-plans over the window, by its
own counters (``EngineStats``): capacity grows (each an overflow redo,
``bin_overflows`` among them), schedule trims and arena spills.  Each
rebuilds a steady pipeline or runs a call on the cold steps path."""


def read(ctx):
    d = ctx.window.counters
    if d is None:
        return None
    return d["capacity_grows"] + d["schedule_trims"] + d["arena_spills"]
