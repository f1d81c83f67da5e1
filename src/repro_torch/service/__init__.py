"""Long-running scheduler service with WAL-backed crash recovery.

The durable front end over the steppable engine (docs/SERVICE.md,
DESIGN.md §10):

* :class:`SchedulerService` — submit/status/cancel/reconfigure over one
  stream-open :class:`~repro_torch.core.engine.SimulationEngine` or a
  :class:`~repro_torch.fleet.simulator.FleetStream`, with an append-only WAL,
  periodic pickled checkpoints, and snapshot+tail recovery that is
  bit-identical to an uninterrupted run;
* :class:`ServiceServer` / :class:`ServiceClient` — a single-threaded
  unix-socket JSON-lines front end (``python -m repro_torch.service serve``);
* :func:`make_policy` — the registry of picklable repartition policies a
  durable service may run (``static``/``nomig``/``daynight``/
  ``heuristic``/``forecast``);
* :class:`ServiceStats` — incremental result aggregates that reproduce
  ``engine.result()`` float-for-float after jobs are folded out of the
  engine to bound memory;
* :class:`ReplayClock`, :class:`WriteAheadLog`, :class:`CheckpointStore` —
  the pacing and durability primitives.

The port's own copy of ``repro.service``: host code that does no device
work; the WAL's record layout and ``service.json`` are the reference's.
"""

from repro_torch.service.checkpoint import CheckpointStore
from repro_torch.service.clock import ReplayClock
from repro_torch.service.records import (
    WAL_FORMAT,
    job_from_dict,
    job_to_dict,
    validate_record,
)
from repro_torch.service.server import ServiceClient, ServiceServer, wait_for_socket
from repro_torch.service.service import (
    POLICY_SPECS,
    SchedulerService,
    ServiceConfig,
    ServiceStats,
    make_policy,
    sim_result_to_dict,
)
from repro_torch.service.wal import WriteAheadLog, read_wal

__all__ = [
    "CheckpointStore",
    "POLICY_SPECS",
    "ReplayClock",
    "SchedulerService",
    "ServiceClient",
    "ServiceConfig",
    "ServiceServer",
    "ServiceStats",
    "WAL_FORMAT",
    "WriteAheadLog",
    "job_from_dict",
    "job_to_dict",
    "make_policy",
    "read_wal",
    "sim_result_to_dict",
    "validate_record",
    "wait_for_socket",
]
