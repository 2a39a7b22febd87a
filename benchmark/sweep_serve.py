#!/usr/bin/env python3
"""The sweep that finds a serving cell's knee, on the card (run once when
the cell is defined; the benchmark's runs never run it):

    python3 benchmark/sweep_serve.py --workload adaptive.serve.b32 --rates 200,300,400 \
        [--seconds 20] [--seed 7] [--clients 64]

One service (the cell's configuration, batch and window, seeded weights),
then one level a rate: the cell's open-loop arrivals at that rate for
--seconds. Each level prints offered and answered requests, shed and other
failures, the backlog (queue depth) when the last request falls due,
p50/p95 from due, and the generator's lateness. The knee is the highest
rate at which nothing is shed and the backlog is at most one batch, in
every repeat (one process a repeat, each with its own --seed). --clients
overrides the cell's pool of client threads, to show that the pool
neither caps the load nor takes the host from the service.
"""

import json
import math
import os
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--clients", type=int, default=None)
    args = p.parse_args(argv)
    import torch

    from benchmark.harness import HERE, cell_spec, load_json, smi, with_later
    from benchmark.kinds.serve_open_loop import OpenLoop, arrivals, p95_ms, start_service

    if not torch.cuda.is_available():
        print("sweep_serve.py: no card", file=sys.stderr)
        return 1
    w = cell_spec(with_later(load_json(ROOT / "BENCHMARK.json")), args.workload)
    config = load_json(HERE / "configs" / f"{w['config']}.json")
    tr = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    clients = args.clients or tr["clients"]
    print(f"[device] {smi()}", flush=True)
    svc, pool, _, _ = start_service(config, tr, args.seed, "cuda", {})
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            due = arrivals(rate, args.seconds, args.seed)
            before = svc.stats()
            t0 = time.perf_counter()
            load = OpenLoop(svc.caption, pool, due, clients, tr["timeout_s"], t0)
            time.sleep(max(0.0, t0 + due[-1] - time.perf_counter()))
            backlog = svc.stats()["queue_depth"]
            load.join()
            after = svc.stats()
            ms = sorted(1e3 * x for x in load.latency)
            late = sorted(load.late)
            n = len(due)
            print(json.dumps({
                "rate": rate, "clients": clients, "seed": args.seed, "requests": n,
                "answered": sum(a is not None for a in load.answers),
                "shed": after["shed"] - before["shed"],
                "timeouts": after["timeouts"] - before["timeouts"],
                "errors": after["errors"] - before["errors"],
                "backlog_at_last_due": backlog,
                "batches": after["batches"] - before["batches"],
                "p50_ms": ms[n // 2], "p95_ms": p95_ms(load.latency),
                "late_p50_ms": 1e3 * late[n // 2],
                "late_p99_ms": 1e3 * late[min(n - 1, math.ceil(0.99 * n) - 1)],
                "late_max_ms": 1e3 * late[-1]}), flush=True)
            time.sleep(1.0)  # let the queue drain between levels
    finally:
        svc.close()
        for t in threading.enumerate():
            if t is not threading.main_thread():
                t.join(timeout=10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
