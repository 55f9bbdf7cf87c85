"""Batched serving with continuous batching (per-slot positions), on the
card by default.

The port's ``examples/serve_lm.py``.  It also shows the robustness
surface: an oversized prompt comes back as a structured rejection
(``req.error``) instead of stopping the engine, and the run's telemetry
is scraped from a live ``/metrics`` endpoint (a stdlib HTTP server on
localhost, as the SpGEMM service's).

Run:  PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]
"""
import argparse
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.engine.telemetry import merge_sample_blocks
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServingEngine

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
device = ap.parse_args().device

cfg = get_arch("qwen3-1.7b").reduced().replace(
    num_layers=4, d_model=128, d_ff=256, vocab_size=1024, dtype="float32")
model = Model(cfg)
params = model.init(torch.Generator().manual_seed(0), device)

engine = ServingEngine(model, params, max_batch=4, max_len=96,
                       telemetry=True)
rng = np.random.default_rng(0)
n_req = 10
requests = {}
for uid in range(n_req):
    plen = int(rng.integers(4, 24))
    requests[uid] = Request(
        uid=uid, prompt=rng.integers(0, 1024, plen).astype(np.int32),
        max_new_tokens=12)
    engine.submit(requests[uid])
# One malformed request: its prompt cannot fit the cache.  The engine
# must reject it structurally and keep serving everyone else.
requests[n_req] = Request(
    uid=n_req, prompt=rng.integers(0, 1024, 200).astype(np.int32))
engine.submit(requests[n_req])

t0 = time.perf_counter()
results = engine.run()
dt = time.perf_counter() - t0
served = [uid for uid in results if requests[uid].error is None]
rejected = [uid for uid in results if requests[uid].error is not None]
tokens = sum(len(v) for v in results.values())
print(f"served {len(served)}/{n_req + 1} requests "
      f"({len(rejected)} rejected), {tokens} tokens "
      f"in {dt:.1f}s ({tokens/dt:.1f} tok/s on {engine.device})")
for uid in sorted(served)[:3]:
    print(f"  req {uid}: {results[uid]}")
for uid in rejected:
    print(f"  req {uid}: REJECTED: {requests[uid].error}")


# -- scrape the run's metrics over HTTP ------------------------------------
# ServingEngine publishes into the same registry machinery as the SpGEMM
# engines; serve its sample blocks the way SpgemmService does.
class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):
        body = merge_sample_blocks(
            [engine.telemetry.registry.sample_blocks()]).encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        pass


server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
thread = threading.Thread(target=server.serve_forever, daemon=True)
thread.start()
url = f"http://127.0.0.1:{server.server_address[1]}/metrics"
try:
    with urllib.request.urlopen(url, timeout=30) as resp:
        body = resp.read().decode()
finally:
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)

print(f"\n/metrics scrape ({url}):")
for line in body.splitlines():
    if line.startswith("opsparse_serve_") or "# TYPE opsparse_serve" in line:
        print(f"  {line}")
