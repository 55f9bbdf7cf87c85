"""fresh_engine: each product is ``SpgemmEngine(config).execute(A, A)`` on
a new engine, planned cold, nothing learned carried over; with telemetry
on (the traced run) each engine's finished spans are kept."""
from opbench.harness import ClosedLoop


class Driver(ClosedLoop):
    def product(self):
        from repro_torch.engine.executor import SpgemmEngine
        engine = SpgemmEngine(self.config, telemetry=self.telemetry)
        res = engine.execute(self.A, self.A)
        if self.telemetry:
            self.spans.extend(engine.telemetry.finished_spans())
        return res
