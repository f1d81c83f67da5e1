"""CLI for the scheduler service: ``python -m repro_torch.service <cmd>``.

Server side::

    python -m repro_torch.service serve --dir /tmp/svc --socket /tmp/svc.sock \\
        --policy daynight --scheduler EDF-SS --speedup 60

Client side (against a running server)::

    python -m repro_torch.service submit --socket /tmp/svc.sock --work 12 \\
        --kind training --elasticity linear --deadline-slack 90
    python -m repro_torch.service status --socket /tmp/svc.sock [--job 3]
    python -m repro_torch.service cancel --socket /tmp/svc.sock --job 3
    python -m repro_torch.service reconfigure --socket /tmp/svc.sock --config 6
    python -m repro_torch.service close --socket /tmp/svc.sock
    python -m repro_torch.service shutdown --socket /tmp/svc.sock

Headless (no server)::

    python -m repro_torch.service replay --dir /tmp/svc --scenario trace-scaled \\
        --seed 3 --max-jobs 200 --pace-ms 0

``replay`` feeds a registered scenario through an in-process service —
creating the workdir on first run, *recovering and resuming* on later
runs (already-submitted job ids are skipped, so a SIGKILLed replay picks
up exactly where the WAL left off; the crash-recovery tests drive this).
Every command prints one JSON object to stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional

from repro_torch.service.clock import ReplayClock
from repro_torch.service.server import ServiceClient, ServiceServer
from repro_torch.service.service import (
    POLICY_SPECS,
    SchedulerService,
    ServiceConfig,
    sim_result_to_dict,
)


def _emit(obj: Dict[str, Any]) -> None:
    json.dump(obj, sys.stdout, sort_keys=True)
    sys.stdout.write("\n")
    sys.stdout.flush()


def _config_from_args(args: argparse.Namespace) -> ServiceConfig:
    return ServiceConfig(
        scheduler=args.scheduler,
        policy=args.policy,
        profile=args.profile,
        repartition_mode=args.repartition_mode,
        initial_config=args.initial_config,
        checkpoint_every_min=args.checkpoint_every_min,
        wal_fsync=args.wal_fsync,
        fleet_profiles=tuple(args.fleet) if args.fleet else None,
        dispatcher=args.dispatcher,
    )


def _add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scheduler", default="EDF-SS")
    p.add_argument(
        "--policy", default="daynight", help=f"one of {', '.join(POLICY_SPECS)}"
    )
    p.add_argument("--profile", default="a100-250w")
    p.add_argument("--repartition-mode", default="partial",
                   choices=("partial", "drain"))
    p.add_argument("--initial-config", type=int, default=None)
    p.add_argument("--checkpoint-every-min", type=float, default=60.0,
                   help="sim-minutes between checkpoints (0 disables)")
    p.add_argument("--wal-fsync", action="store_true")
    p.add_argument("--fleet", nargs="*", default=None,
                   help="device profile names; omit for a single device")
    p.add_argument("--dispatcher", default="least-loaded")


def _cmd_serve(args: argparse.Namespace) -> int:
    clock = (
        ReplayClock(speedup=args.speedup) if args.speedup > 0 else ReplayClock.free()
    )
    service = SchedulerService(
        args.dir,
        None if args.recover_only else _config_from_args(args),
        clock=clock,
    )
    _emit(
        {
            "serving": True,
            "socket": args.socket,
            "dir": args.dir,
            "recovered_ops": service.recovered_ops,
            "t": service.applied_until,
        }
    )
    ServiceServer(service, args.socket).serve_forever()
    return 0


def _cmd_replay(args: argparse.Namespace) -> int:
    from repro_torch.core.scenarios import generate_scenario

    jobs = generate_scenario(args.scenario, args.seed)
    if args.max_jobs is not None:
        jobs = jobs[: args.max_jobs]
    service = SchedulerService(args.dir, _config_from_args(args))
    fed = skipped = 0
    for job in jobs:
        if job.job_id in service.known_jobs:
            skipped += 1
            continue
        service.submit(job)
        fed += 1
        if args.pace_ms > 0:
            time.sleep(args.pace_ms / 1000.0)
    if not service.closed:
        service.close()
    res = service.result()
    service.shutdown()
    _emit(
        {
            "replayed": True,
            "fed": fed,
            "skipped": skipped,
            "recovered_ops": service.recovered_ops,
            "result": sim_result_to_dict(res),
        }
    )
    return 0


def _client_cmd(args: argparse.Namespace) -> int:
    client = ServiceClient(args.socket)
    try:
        if args.cmd == "submit":
            fields: Dict[str, Any] = {"work": args.work, "kind": args.kind,
                                      "elasticity": args.elasticity}
            if args.deadline is not None:
                fields["deadline"] = args.deadline
            else:
                fields["deadline_slack_min"] = args.deadline_slack
            if args.arrival is not None:
                fields["arrival"] = args.arrival
            if args.job is not None:
                fields["job_id"] = args.job
            if args.tenant is not None:
                fields["tenant"] = args.tenant
            if args.slo_min is not None:
                fields["slo_min"] = args.slo_min
            out = client.submit(**fields)
        elif args.cmd == "status":
            out = {"status": client.status(args.job)}
        elif args.cmd == "cancel":
            out = client.cancel(args.job)
        elif args.cmd == "reconfigure":
            out = client.reconfigure(args.config, args.device)
        elif args.cmd == "checkpoint":
            out = {"checkpoint": client.checkpoint()}
        elif args.cmd == "close":
            out = {"result": client.close_stream()}
        elif args.cmd == "result":
            out = {"result": client.result()}
        elif args.cmd == "shutdown":
            out = client.shutdown()
        else:  # pragma: no cover - argparse prevents this
            raise ValueError(args.cmd)
    finally:
        client.close()
    out.pop("ok", None)
    _emit(out)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.service",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve", help="run the service behind a unix socket")
    p.add_argument("--dir", required=True)
    p.add_argument("--socket", required=True)
    p.add_argument("--speedup", type=float, default=60.0,
                   help="sim-minutes per wall-minute; 0 = op-driven time")
    p.add_argument("--recover-only", action="store_true",
                   help="refuse to create a fresh service (must recover)")
    _add_config_args(p)

    p = sub.add_parser("replay", help="feed a scenario through an in-process service")
    p.add_argument("--dir", required=True)
    p.add_argument("--scenario", default="trace-scaled")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-jobs", type=int, default=None)
    p.add_argument("--pace-ms", type=float, default=0.0,
                   help="wall-ms to sleep between submissions (crash tests)")
    _add_config_args(p)

    for name, hlp in (
        ("submit", "submit one job"),
        ("status", "service summary or one job's disposition"),
        ("cancel", "cancel a job"),
        ("reconfigure", "manually repartition a device"),
        ("checkpoint", "force a checkpoint now"),
        ("close", "end the stream, drain, print the final result"),
        ("result", "print the final result (after close)"),
        ("shutdown", "checkpoint and stop the server"),
    ):
        p = sub.add_parser(name, help=hlp)
        p.add_argument("--socket", required=True)
        if name == "submit":
            p.add_argument("--work", type=float, default=10.0)
            p.add_argument("--kind", default="inference",
                           choices=("inference", "training"))
            p.add_argument("--elasticity", default="linear")
            p.add_argument("--deadline", type=float, default=None)
            p.add_argument("--deadline-slack", type=float, default=60.0)
            p.add_argument("--arrival", type=float, default=None)
            p.add_argument("--job", type=int, default=None)
            p.add_argument("--tenant", default=None)
            p.add_argument("--slo-min", type=float, default=None)
        elif name in ("status", "cancel"):
            p.add_argument("--job", type=int,
                           default=None, required=(name == "cancel"))
        elif name == "reconfigure":
            p.add_argument("--config", type=int, required=True)
            p.add_argument("--device", type=int, default=0)

    args = ap.parse_args(argv)
    if args.cmd == "serve":
        return _cmd_serve(args)
    if args.cmd == "replay":
        return _cmd_replay(args)
    return _client_cmd(args)


if __name__ == "__main__":
    sys.exit(main())
