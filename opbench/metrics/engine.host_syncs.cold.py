"""engine.host_syncs.cold: waits of the host on the device a product,
counted from the spans marked ``sync`` in the telemetry of the engines
the window made (each fresh engine's steps path: its step waits and
host reads).  Nothing to read where no span carries the mark."""


def read(ctx):
    syncs = sum(1 for s in ctx.window.spans
                if (s.get("attrs") or {}).get("sync") is True)
    if not syncs or not ctx.products:
        return None
    return syncs / ctx.products
