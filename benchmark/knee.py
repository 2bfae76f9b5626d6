"""Sweep the offered rate of a serving cell, to find its knee once.

    python3 benchmark/knee.py --config vehicle_700m --traffic open_overload \
        --seed <n> --seconds 20 --rates 10,12,14,16,18

Sets the configuration up once behind the serving engine of the traffic
file's driver, then offers each rate in turn as an open loop for
``--seconds`` and prints one JSON line a rate: latencies from when each
request was due, the completed rate, and whether the backlog grew (the
median latency of the last quarter of arrivals against the first's).  The
knee is the highest rate whose backlog does not grow; a serving cell's
traffic file fixes its rate at about four fifths of it.  Not part of a run.
"""

import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--config", default="vehicle_700m")
    p.add_argument("--traffic", default="open_overload")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from harness.main import Context
    from harness.spec import Spec, load_json, system_adapter
    from harness.traffic import arrivals, open_loop, pool_order, wait_all

    spec = Spec(cell={"name": f"{args.config}.{args.traffic}", "chips": 1},
                config=load_json(HERE / "configs" / f"{args.config}.json"),
                traffic=load_json(HERE / "traffic" / f"{args.traffic}.json"), benchmark={})
    ctx = Context(root=ROOT, spec=spec, seed=args.seed, seconds=args.seconds, trace=False,
                  device=torch.device("cuda", 0))
    system = system_adapter(spec.config["system"])
    system.setup(ctx)
    engine = ctx.state["engine"]
    for rate in (float(r) for r in args.rates.split(",")):
        tr = dict(spec.traffic, rate_per_s=rate)
        due = arrivals(tr, args.seconds, args.seed)
        order = pool_order(len(due), tr["pool"], args.seed)
        loop = open_loop(lambda i: engine.submit(ctx.state["sections"][int(order[i])]),
                         due, int(tr["senders"]))
        wait_all(loop, float(tr["drain_s"]))
        lat = np.asarray([(loop.done[i] - loop.due[i]) * 1e3 for i in range(len(due))
                          if i in loop.done and i not in loop.errors])
        q = max(len(due) // 4, 1)
        first = [(loop.done[i] - loop.due[i]) * 1e3 for i in range(q) if i in loop.done]
        last = [(loop.done[i] - loop.due[i]) * 1e3 for i in range(len(due) - q, len(due))
                if i in loop.done]
        span = max(loop.done.values()) - loop.t0
        print(json.dumps({
            "rate_per_s": rate, "requests": len(due), "failed": len(loop.errors),
            "completed_per_s": (len(due) - len(loop.errors)) / span,
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "first_quarter_median_ms": float(np.median(first)),
            "last_quarter_median_ms": float(np.median(last)),
            "backlog_grows": bool(np.median(last) > 2.0 * np.median(first) + 50.0),
            "sender_late_max_ms": max(loop.lateness_ms())}), flush=True)
        time.sleep(2.0)
    system.release(ctx)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    from harness import env

    env.fix(ROOT)
    sys.exit(main(sys.argv[1:]))
