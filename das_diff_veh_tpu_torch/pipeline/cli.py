"""Command-line entry of the port: batch imaging on the card.

    python -m das_diff_veh_tpu_torch.pipeline.cli --data_root /data \
        --start_date 20230301 --end_date 20230307 --x0 700 --method xcorr \
        --prefetch_depth 3 --trace results/run_trace.jsonl

The flags are those of ``das_diff_veh_tpu/pipeline/cli.py``, plus
``--device`` (the card by default; ``cpu`` runs the plain PyTorch path).
Options whose machinery the port does not have yet raise
``NotImplementedError`` naming the ROADMAP item: the ``serve`` subcommand
(item 12), ``--figures`` (item 9), ``--profile_dir`` (item 13), and
``--compilation_cache_dir``, which names XLA's compilation cache and has no
meaning for PyTorch.
"""

from __future__ import annotations

import argparse
import json
import logging

from das_diff_veh_tpu_torch.config import ImagingConfig, ObsConfig, PipelineConfig
from das_diff_veh_tpu_torch.pipeline.workflow import run_date_range
from das_diff_veh_tpu_torch.runtime import RuntimeConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Vehicle-DAS time-lapse imaging on the card")
    p.add_argument("--data_root", help="root with per-date npz folders")
    p.add_argument("--start_date", help="YYYYMMDD")
    p.add_argument("--end_date", help="YYYYMMDD")
    p.add_argument("--out_dir", default="results")
    p.add_argument("--method", default="xcorr", choices=["xcorr", "surface_wave"])
    p.add_argument("--x0", type=float, default=700.0, help="pivot along fiber [m]")
    p.add_argument("--n_min_save", type=float, default=60.0,
                   help="checkpoint the running average every N data-minutes")
    p.add_argument("--max_chunks", type=int, default=None,
                   help="process at most N remaining chunks per date "
                        "(smoke runs; the manifest resumes the rest later)")
    p.add_argument("--verbal", action="store_true", help="per-chunk progress logs")
    p.add_argument("--figures", action="store_true",
                   help="the reference QC figure set (not ported yet: ROADMAP item 9)")
    p.add_argument("--device", default=None,
                   help="torch device of the run (default: the card; 'cpu' runs "
                        "the plain PyTorch path)")
    rt = p.add_argument_group("runtime", "pipelined batch-execution knobs")
    rt.add_argument("--prefetch_depth", type=int, default=2,
                    help="chunks staged ahead by the loader thread; 0 = serial")
    rt.add_argument("--retries", type=int, default=1,
                    help="retry attempts per chunk stage before quarantine")
    rt.add_argument("--retry_backoff", type=float, default=0.05,
                    help="linear backoff unit between retries [s]")
    rt.add_argument("--trace", default=None, metavar="PATH",
                    help="write Chrome-trace JSONL spans to PATH "
                         "(open in chrome://tracing or Perfetto)")
    rt.add_argument("--compilation_cache_dir", default=None, metavar="DIR",
                    help="XLA's persistent compilation cache in the JAX package; "
                         "no meaning for PyTorch (refused)")
    obs = p.add_argument_group("observability", "metrics/flight/profiler knobs")
    obs.add_argument("--metrics_jsonl", default=None, metavar="PATH",
                     help="append periodic metrics-registry snapshots "
                          "(JSON lines) here")
    obs.add_argument("--metrics_interval", type=float, default=10.0,
                     metavar="S", help="seconds between metrics snapshots")
    obs.add_argument("--flight_dir", default=None, metavar="DIR",
                     help="crash-flight-recorder dumps (recent per-chunk "
                          "records as JSON on quarantine/SIGTERM); render "
                          "with scripts/obs_report.py")
    obs.add_argument("--profile_dir", default=None, metavar="DIR",
                     help="profiler window (not ported yet: ROADMAP item 13)")
    obs.add_argument("--profile_chunks", type=int, default=2,
                     help="chunks inside the profiler window")
    obs.add_argument("--trace_flush_interval", type=float, default=0.0,
                     metavar="S", help="batch trace writes, flushing every "
                                       "S seconds (0 = flush per span)")
    return p


def main(argv=None) -> int:
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        raise NotImplementedError("the serve subcommand: serving (serve/) is not "
                                  "ported yet (ROADMAP item 12)")
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbal else logging.WARNING,
                        format="%(asctime)s %(name)s %(message)s")
    if args.compilation_cache_dir:
        raise NotImplementedError("--compilation_cache_dir names XLA's persistent "
                                  "compilation cache, which has no meaning for "
                                  "PyTorch; the port's kernels build into build/kernels/")
    if args.figures:
        raise NotImplementedError("--figures: the figure set (viz.py) is not "
                                  "ported yet (ROADMAP item 9)")
    if not (args.data_root and args.start_date and args.end_date):
        parser.error("--data_root/--start_date/--end_date are "
                     "required unless --figures is given")
    cfg = PipelineConfig().replace(imaging=ImagingConfig(x0=args.x0))
    obs = ObsConfig(metrics_jsonl=args.metrics_jsonl,
                    metrics_interval_s=args.metrics_interval,
                    flight_dir=args.flight_dir,
                    profile_dir=args.profile_dir,
                    profile_n_chunks=args.profile_chunks,
                    trace_flush_interval_s=args.trace_flush_interval)
    runtime = RuntimeConfig(prefetch_depth=args.prefetch_depth,
                            max_retries=args.retries,
                            retry_backoff_s=args.retry_backoff,
                            trace_path=args.trace, obs=obs)
    summary = run_date_range(args.data_root, args.start_date, args.end_date,
                             cfg=cfg, method=args.method, out_dir=args.out_dir,
                             n_min_save=args.n_min_save,
                             max_chunks=args.max_chunks, runtime=runtime,
                             device=args.device)
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
