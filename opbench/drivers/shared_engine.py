"""shared_engine: each product is ``repro_torch.spgemm(A, A, config)`` on
the process-wide engine, so every call after the first reuses its plan
and, once it has one, its steady pipeline.  The engine's counters
(``EngineStats``) are read before and after the window."""
from opbench.harness import ClosedLoop

COUNTERS = ("capacity_grows", "bin_overflows", "schedule_trims",
            "arena_spills")


class Driver(ClosedLoop):
    def product(self):
        from repro_torch import spgemm
        return spgemm(self.A, self.A, self.config)

    def counters(self):
        from repro_torch.engine.executor import default_engine
        stats = default_engine().stats
        return {k: int(getattr(stats, k)) for k in COUNTERS}
