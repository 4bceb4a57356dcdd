"""kepchaos CLI: run randomized schedules, replay a key, shrink.

Exit status: 0 = all schedules green, 1 = an invariant violation (the
failing ``(seed, schedule)`` key, its violations, and copy-paste repro
commands — full and shrunk — are printed) or no CUDA device for
``--device cuda``, 2 = usage error.

Examples::

    python -m kepler_tpu_torch.chaos --schedules 25 --device cpu
    python -m kepler_tpu_torch.chaos --seed 7 --schedule 3   # on the card
    python -m kepler_tpu_torch.chaos --seed 7 --schedule 3 --keep 1,4
    python -m kepler_tpu_torch.chaos --backend pallas --artifact out.json
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kepler_tpu_torch.chaos",
        description="randomized fault-schedule conductor (kepchaos)")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--schedules", type=int, default=25,
                        help="number of schedule indices to sweep")
    parser.add_argument("--schedule", type=int, default=None,
                        help="replay exactly this schedule index")
    parser.add_argument("--keep", type=str, default="",
                        help="comma-separated event indices (replay a "
                             "shrunk subsequence; needs --schedule)")
    parser.add_argument("--no-shrink", action="store_true",
                        help="report the first failure without "
                             "delta-debugging it")
    parser.add_argument("--windows", type=int, default=None,
                        help="override the scheduled-fault horizon")
    parser.add_argument("--agents", type=int, default=None)
    parser.add_argument("--replicas", type=int, default=None)
    parser.add_argument("--artifact", type=str, default="",
                        help="write the ChaosReport JSON here")
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="where the replicas' window engines run")
    parser.add_argument("--backend", choices=("einsum", "pallas"),
                        default="einsum",
                        help="the Aggregators' window backend (pallas: "
                             "the hand-written CUDA kernels)")
    parser.add_argument("--shards", type=int, default=8,
                        help="virtual shards of the device in each "
                             "replica's mesh (8, as the reference's "
                             "sweep runs on 8 host devices)")
    args = parser.parse_args(argv)

    if args.keep and args.schedule is None:
        parser.error("--keep requires --schedule")

    # heavy imports only after the arguments parse (they pull in torch)
    from kepler_tpu_torch.chaos.conductor import (
        ChaosReport, repro_command, run_many, run_schedule, shrink)
    from kepler_tpu_torch.chaos.harness import ChaosConfig
    from kepler_tpu_torch.chaos.schedule import generate
    from kepler_tpu_torch.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as err:
        print(f"error: {err} (run with --device cpu to use the CPU)",
              file=sys.stderr)
        return 1
    cfg = ChaosConfig(device=args.device, backend=args.backend,
                      shards=max(1, args.shards))
    if args.windows is not None:
        cfg.horizon = max(1, args.windows)
    if args.agents is not None:
        cfg.agents = max(1, args.agents)
    if args.replicas is not None:
        cfg.replicas = max(1, args.replicas)
    members = [f"10.99.0.{i + 1}:28283" for i in range(cfg.replicas)]
    standbys = [f"10.99.0.{i + 1}:28283"
                for i in range(cfg.replicas,
                               cfg.replicas + cfg.standbys)]

    if args.schedule is not None:
        schedule = generate(args.seed, args.schedule,
                            horizon=cfg.horizon, members=members,
                            standbys=standbys)
        if args.keep:
            schedule = schedule.subset(
                [int(k) for k in args.keep.split(",") if k != ""])
        result = run_schedule(schedule, cfg)
        report = ChaosReport(seed=args.seed, requested=1,
                             device=cfg.device, results=[result],
                             failure=None if result.ok else result)
        if not result.ok and not args.no_shrink and not args.keep:
            report.shrunk, report.shrink_runs = shrink(schedule, cfg)
    else:
        report = run_many(args.seed, args.schedules, cfg,
                          do_shrink=not args.no_shrink)

    for result in report.results:
        sched = result.schedule
        verdict = "green" if result.ok else "RED"
        print(f"schedule (seed={sched.seed}, index={sched.index}): "
              f"{verdict} — {len(sched.events)} events, "
              f"{result.windows_published} windows published, "
              f"trace {result.trace_hash[:16]}")
    if report.failure is not None:
        fail = report.failure
        print()
        print(f"FAILED (seed={fail.schedule.seed}, "
              f"index={fail.schedule.index}):")
        for violation in fail.violations:
            print(f"  {violation}")
        print(f"repro: "
              f"{repro_command(fail.schedule, cfg.device, cfg.shards)}")
        if report.shrunk is not None:
            print(f"shrunk to {len(report.shrunk.events)} events in "
                  f"{report.shrink_runs} replays:")
            for event in report.shrunk.events:
                print(f"  {event.to_dict()}")
            print("repro (shrunk): "
                  f"{repro_command(report.shrunk, cfg.device, cfg.shards)}")
    else:
        print(f"all {len(report.results)} schedules green "
              f"(seed={report.seed})")
    if args.artifact:
        with open(args.artifact, "w") as fh:
            json.dump(report.to_artifact(), fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"artifact: {args.artifact}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
