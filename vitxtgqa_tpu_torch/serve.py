"""Serving-engine demo: dynamic-batching T2S inference on synthetic
requests from concurrent clients.

    python -m vitxtgqa_tpu_torch.serve

Counterpart of tools/serve.py, with its contract: a ServingEngine
(serving/engine.py) around the production T2S serving model
(models/t2s.t2s_production_config(), 5,050 + 960 answers, bos 2, bf16,
``inference_only``, random weights from seed 0), ``SERVE_REQUESTS``
requests from ``SERVE_CLIENTS`` threads, each drawing samples from a pool
of 16 (utils/synthetic.synthetic_batch(batch=16, seed=0)) with
``np.random.default_rng(client)`` and sleeping ``exponential(1 /
SERVE_RPS)`` between its requests; one JSON line with the JAX tool's keys
(latency percentiles, the group count) and the card's name.

Env knobs, with the JAX tool's defaults: SERVE_BUCKETS ("8,48"),
SERVE_WAIT_MS (5), SERVE_CLIENTS (8), SERVE_REQUESTS (96 in all),
SERVE_RPS (50 a client), BENCH_KV_INT8 (1: the int8 KV cache),
BENCH_COMPACT (0: compact serving off), BENCH_PALLAS (1: the kernels; 0
raises on the card, where the plain versions are the oracle and never the
main path; on the CPU the plain versions run either way).

It runs on the card; ``serve(device="cpu")`` runs the plain versions on
the CPU, and without CUDA nothing else runs.  ``warmup_s`` is, as in the
JAX tool, the time from building the model to the end of the engine's
warm-up (each bucket once: the kernels' first launches, the allocator).

A known difference: the JAX tool casts the float features to bf16 on the
host (tools/serve.py:74-76).  numpy has no bf16, so the port sends float32
and the model casts them on the card: at bucket 48 about 3.8 MB a sample
and 180 MB a group, one pageable copy an array in the engine's dispatcher
(ServingEngine.copy_in).  The line before the JSON one gives that copy's
share of the demo's wall time, from CUDA events around each group's copy.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from vitxtgqa_tpu_torch.models.t2s import PRODUCTION_NUM_FINAL_OUTPUTS, T2S, t2s_production_config
from vitxtgqa_tpu_torch.options import Options, entry_device
from vitxtgqa_tpu_torch.serving.engine import ServingEngine
from vitxtgqa_tpu_torch.utils.synthetic import synthetic_batch

POOL = 16


@dataclasses.dataclass(frozen=True)
class Knobs:
    """The demo's settings (tools/serve.py's env knobs and defaults)."""

    buckets: Tuple[int, ...] = (8, 48)
    wait_ms: float = 5.0
    clients: int = 8
    requests: int = 96
    rps: float = 50.0
    kv_cache_int8: bool = True
    compact_serving: bool = False
    kernels: bool = True

    @classmethod
    def from_env(cls, env=os.environ) -> "Knobs":
        return cls(
            buckets=tuple(int(b) for b in env.get("SERVE_BUCKETS", "8,48").split(",")),
            wait_ms=float(env.get("SERVE_WAIT_MS", "5")),
            clients=int(env.get("SERVE_CLIENTS", "8")),
            requests=int(env.get("SERVE_REQUESTS", "96")),
            rps=float(env.get("SERVE_RPS", "50")),
            kv_cache_int8=env.get("BENCH_KV_INT8", "1") == "1",
            compact_serving=env.get("BENCH_COMPACT", "0") == "1",
            kernels=env.get("BENCH_PALLAS", "1") == "1",
        )


class CopyTimedEngine(ServingEngine):
    """The engine, recording each group's size and its copy to the card
    between two CUDA events."""

    def __init__(self, *args, **kw):
        self.copies = []  # (start event, end event, bytes) a group
        self.group_sizes = []  # the requests of each group, in dispatch order
        super().__init__(*args, **kw)

    def _collect_group(self):
        group = super()._collect_group()
        if group:
            self.group_sizes.append(len(group))
        return group

    def copy_in(self, batch):
        if self.device.type != "cuda":
            return super().copy_in(batch)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = super().copy_in(batch)
        end.record()
        self.copies.append((start, end, sum(np.asarray(v).nbytes for v in batch.values())))
        return out


def serve(model_config: Optional[Dict[str, Any]] = None, device=None,
          knobs: Optional[Knobs] = None,
          num_final_outputs: int = PRODUCTION_NUM_FINAL_OUTPUTS,
          batch_kw: Optional[Dict[str, Any]] = None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Run the demo; returns (the JSON report, details: each response as
    (client, pool index, output row) in completion order, the engine's
    group sizes, the copies' device ms, bytes and share of the wall time).
    ``model_config`` (default: the production T2S) and ``batch_kw``
    (synthetic_batch's geometry) let a test run a tiny model; ``knobs``
    defaults to the environment's (Knobs.from_env)."""
    knobs = Knobs.from_env() if knobs is None else knobs
    dev = entry_device(device)
    if dev.type == "cuda" and not knobs.kernels:
        raise ValueError("BENCH_PALLAS=0 on the card: the port serves through its kernels there; "
                         "the plain versions are the oracle (Options.plain), never the main path")
    cfg = t2s_production_config() if model_config is None else model_config

    t0 = time.time()
    model = T2S(cfg, num_final_outputs, bos_idx=2, inference_only=True, opts=Options(
        device=dev, kv_cache_int8=knobs.kv_cache_int8,
        compact_serving=knobs.compact_serving)).init_weights(0)
    pool = synthetic_batch(batch=POOL, num_final_outputs=num_final_outputs, seed=0,
                           **(batch_kw or {}))
    samples = [{k: np.asarray(v)[i] for k, v in pool.items()} for i in range(POOL)]
    engine = CopyTimedEngine(model, buckets=knobs.buckets, max_wait_ms=knobs.wait_ms)
    try:
        engine.warmup(samples[0])
        warm_s = time.time() - t0
        engine.copies.clear()

        latencies, responses, errors = [], [], []
        lock = threading.Lock()
        per_client = knobs.requests // knobs.clients

        def client(ci: int):
            rng = np.random.default_rng(ci)
            try:
                for _ in range(per_client):
                    i = int(rng.integers(0, len(samples)))
                    t = time.monotonic()
                    row = engine.submit(samples[i]).result(timeout=600)
                    dt = (time.monotonic() - t) * 1000
                    with lock:
                        latencies.append(dt)
                        responses.append((ci, i, row))
                    time.sleep(max(0.0, rng.exponential(1.0 / knobs.rps)))
            except Exception as e:  # raised in the caller after the join
                with lock:
                    errors.append(e)

        t1 = time.time()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(knobs.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t1
    finally:
        engine.stop()
    if errors:
        raise errors[0]

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        name = torch.cuda.get_device_name(dev)
    else:
        name = "cpu"
    copy_ms = [s.elapsed_time(e) for s, e, _ in engine.copies]
    lat = np.sort(np.asarray(latencies))
    report = {
        "metric": "t2s_serving_engine_demo",
        "requests": len(lat),
        "clients": knobs.clients,
        "buckets": list(knobs.buckets),
        "wait_ms": knobs.wait_ms,
        "warmup_s": round(warm_s, 2),
        "throughput_rps": round(len(lat) / wall, 2),
        "latency_ms": {
            "p50": round(float(lat[len(lat) // 2]), 2),
            "p90": round(float(lat[int(len(lat) * 0.9)]), 2),
            "p99": round(float(lat[min(len(lat) - 1, int(len(lat) * 0.99))]), 2),
        },
        "groups": engine._group_counter,
        "device": name,
    }
    details = {
        "responses": responses, "group_sizes": list(engine.group_sizes), "wall_s": wall,
        "latencies_ms": latencies, "h2d_ms": copy_ms,
        "h2d_bytes": [b for _, _, b in engine.copies],
        # None on the CPU, where nothing is copied
        "h2d_share": sum(copy_ms) / (wall * 1e3) if dev.type == "cuda" else None,
    }
    return report, details


def main() -> int:
    report, details = serve()
    sizes = details["group_sizes"]
    share = details["h2d_share"]
    print(f"serve: {len(sizes)} groups of {sizes}; host-to-device copies "
          f"{sum(details['h2d_bytes']) / 1e6:.1f} MB in {sum(details['h2d_ms']):.1f} ms of device "
          f"time, {'not measured' if share is None else f'{share:.4f}'} of the "
          f"{details['wall_s']:.3f} s wall", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
