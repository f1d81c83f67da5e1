"""The paper's own experimental configuration (§V-A) as a config object
(counterpart of ``repro.configs.paper_a100``)."""

import dataclasses

from repro_torch.core.power import A100_250W
from repro_torch.core.workload import WorkloadSpec


@dataclasses.dataclass(frozen=True)
class PaperA100Config:
    """A100-40GB, 250W cap, §V-A workload; scheduler EDF-SS (restricted)."""

    scheduler: str = "EDF-SS"
    workload: WorkloadSpec = dataclasses.field(default_factory=WorkloadSpec)
    static_benchmark_config: int = 3  # §V-A: best fixed configuration
    day_config: int = 6  # §V-A: day-time (5:00-17:00)
    night_config: int = 2  # §V-A: night-time
    repartition_penalty_s: float = 4.0  # §IV-D-3
    in_config_iterations: int = 250  # §V-A
    repartition_iterations: int = 500  # §V-A

    @property
    def power_model(self):
        return A100_250W


CONFIG = PaperA100Config()
