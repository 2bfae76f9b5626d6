"""Read a cell's control: the reference in a lower precision put in the
program's place, held to the cell's own check.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--seconds 8]

The frozen reference in float32 with TF32 matrix products (the program runs
float32 with TF32 off) makes the outputs, in the form of the window's.
Prints one JSON line a seed with every number compared; a sound control
fails at least one of them.  Not part of a run: the limits in the
configuration files were set from these readings and from the cells' own
runs.
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
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    args = p.parse_args(argv)

    import torch

    from harness.main import Context, Window
    from harness.spec import load_spec, system_adapter

    for seed in (int(s) for s in args.seeds.split(",")):
        spec = load_spec(ROOT, args.workload)
        system = system_adapter(spec.config["system"])
        t0 = time.perf_counter()
        ctx = Context(root=ROOT, spec=spec, seed=seed, seconds=args.seconds, trace=False,
                      device=torch.device("cuda", 0))
        system.setup(ctx)
        system.release(ctx)
        win = Window(end_to_end={}, attempted=0, failed=0,
                     outputs=system.control_outputs(ctx))
        checks = system.check(ctx, win)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "failed_checks": [c.name for c in checks if not c.ok],
                          "checks": {c.name: {"value": c.value, "limit": c.limit}
                                     for c in checks},
                          "seconds": time.perf_counter() - t0}), flush=True)
        del ctx, system
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    from harness import env

    env.fix(ROOT)
    sys.exit(main(sys.argv[1:]))
