"""The paper's MIG scheduling model, as far as the port has it.

Host copies of the reference's framework-free modules (the port imports
nothing of ``repro``):

* :mod:`repro_torch.core.slices`    — Fig. 1 slice/partition model (12 configs), the A30 table
* :mod:`repro_torch.core.power`     — Fig. 3 saturating power curve, the A30 and TPU-pod curves
* :mod:`repro_torch.core.jobs`      — jobs with linear/capped/sublinear elasticity
* :mod:`repro_torch.core.workload`  — §V-A diurnal Poisson workload generator
* :mod:`repro_torch.core.scenarios` — named workload scenario registry
* :mod:`repro_torch.core.serving`   — multi-tenant serving streams, configs mapped to MIG classes
* :mod:`repro_torch.core.metrics`   — the per-run result record and the ET metric
* :mod:`repro_torch.core.engine`    — the event loop (the bit-exact oracle)
* :mod:`repro_torch.core.simulator` — ``MIGSimulator`` and the repartitioning policies
* :mod:`repro_torch.core.schedulers` — EDF-FS, EDF-SS, LLF and LALF

and the batched simulator on the device, :mod:`repro_torch.core.batched`.
"""

from repro_torch.core.jobs import Elasticity, ElasticityClass, Job, JobKind
from repro_torch.core.metrics import SimResult
from repro_torch.core.power import A100_250W, PowerModel
from repro_torch.core.scenarios import SCENARIOS, generate_scenario, scenario_names
from repro_torch.core.simulator import (
    REPARTITION_PENALTY_MIN,
    DayNightPolicy,
    NoMIGPolicy,
    StaticPolicy,
)
from repro_torch.core.slices import MIG_CONFIGS, NUM_CONFIGS, Partition, SliceType
from repro_torch.core.workload import WorkloadSpec, arrival_rate, generate_jobs

__all__ = [
    "MIG_CONFIGS",
    "NUM_CONFIGS",
    "Partition",
    "SliceType",
    "A100_250W",
    "PowerModel",
    "Elasticity",
    "ElasticityClass",
    "Job",
    "JobKind",
    "WorkloadSpec",
    "generate_jobs",
    "arrival_rate",
    "SCENARIOS",
    "generate_scenario",
    "scenario_names",
    "SimResult",
    "DayNightPolicy",
    "NoMIGPolicy",
    "StaticPolicy",
    "REPARTITION_PENALTY_MIN",
]
