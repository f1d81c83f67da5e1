"""Wire and WAL codecs for the scheduler service (docs/SERVICE.md).

Two codecs live here:

* ``job_to_dict`` / ``job_from_dict`` — a :class:`~repro_torch.core.jobs.Job` as a
  JSON-safe dict.  Only *submission-time* fields are encoded (id, kind,
  arrival, work, deadline, elasticity label, NoMIG speedup, tenant/SLO):
  a WAL job record is the submission, not the outcome — mutable scheduling
  state (``remaining``, ``completion``, preemption counters) is recomputed
  by replay, never stored.  Elasticity round-trips through its canonical
  label (:func:`repro_torch.core.jobs.elasticity_from_label`), and floats survive
  JSON exactly (``json`` emits the shortest repr that round-trips), so a
  decoded job depletes bit-identically to the original.

* WAL op records — one JSON object per line, schema::

      {"seq": 7, "op": "submit",      "t": 12.5, "job": {...}}
      {"seq": 8, "op": "cancel",      "t": 30.0, "job_id": 3}
      {"seq": 9, "op": "reconfigure", "t": 45.0, "config": 6, "device": 0}
      {"seq": 10, "op": "close",      "t": 200.0}

  ``seq`` is the service's strictly increasing op counter; ``t`` is the
  sim-time the op was applied at (the replay clock's reading, floored to be
  nondecreasing).  Recovery replays a record by advancing the engine to
  ``t`` (exclusive) and re-applying the op — see
  :meth:`repro_torch.service.SchedulerService.recover`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

from repro_torch.core.jobs import Job, JobKind, elasticity_from_label

__all__ = [
    "WAL_FORMAT",
    "WAL_OPS",
    "job_to_dict",
    "job_from_dict",
    "validate_record",
]

#: bump when the record schema changes incompatibly
WAL_FORMAT = 1

#: every op a WAL line may carry, with its required extra fields
WAL_OPS: Mapping[str, tuple] = {
    "submit": ("job",),
    "cancel": ("job_id",),
    "reconfigure": ("config",),
    "close": (),
}


def job_to_dict(job: Job) -> Dict[str, Any]:
    """Encode a job's submission-time fields as a JSON-safe dict."""
    d: Dict[str, Any] = {
        "job_id": job.job_id,
        "kind": job.kind.value,
        "arrival": job.arrival,
        "work": job.work,
        "deadline": job.deadline,
        "elasticity": job.elasticity.label,
    }
    # optional fields are emitted only when set, keeping records minimal
    # and byte-stable for the common batch job
    if job.speedup_no_mig != 1.0:
        d["speedup_no_mig"] = job.speedup_no_mig
    if job.tenant is not None:
        d["tenant"] = job.tenant
    if job.slo_min is not None:
        d["slo_min"] = job.slo_min
    return d


def job_from_dict(d: Mapping[str, Any]) -> Job:
    """Decode :func:`job_to_dict` output back into a fresh Job."""
    return Job(
        job_id=int(d["job_id"]),
        kind=JobKind(d["kind"]),
        arrival=float(d["arrival"]),
        work=float(d["work"]),
        deadline=float(d["deadline"]),
        elasticity=elasticity_from_label(d["elasticity"]),
        speedup_no_mig=float(d.get("speedup_no_mig", 1.0)),
        tenant=d.get("tenant"),
        slo_min=d.get("slo_min"),
    )


def validate_record(rec: Mapping[str, Any]) -> None:
    """Reject a malformed WAL record with a message naming what's wrong.

    Called on every record during recovery so a hand-edited or
    version-skewed WAL fails loudly at replay time, not as a KeyError deep
    inside an op application.
    """
    op = rec.get("op")
    if op not in WAL_OPS:
        raise ValueError(
            f"WAL record {rec.get('seq')!r} has unknown op {op!r}; "
            f"valid ops: {sorted(WAL_OPS)}"
        )
    if not isinstance(rec.get("seq"), int):
        raise ValueError(f"WAL record missing integer 'seq': {dict(rec)!r}")
    if not isinstance(rec.get("t"), (int, float)):
        raise ValueError(f"WAL record {rec['seq']} missing numeric 't'")
    for field in WAL_OPS[op]:
        if field not in rec:
            raise ValueError(
                f"WAL record {rec['seq']} (op {op!r}) missing field {field!r}"
            )
