"""Device profiles: the per-GPU hardware identity of a fleet member.

A :class:`DeviceProfile` bundles what the single-GPU layers keep implicit —
the Fig. 3 power curve and the Fig. 1 partition table — so a fleet can mix
A100-class and A30-class devices (or the TPU-pod analogue) while each
per-device :class:`~repro_torch.core.simulator.MIGSimulator` stays unchanged.

Profiles are referenced by name in sweep cells (a profile object is not
JSON); the registry is the single source of truth for that mapping.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

from repro_torch.core.power import A100_250W, A30_165W, TPU_V5E_POD, PowerModel
from repro_torch.core.slices import (
    A30_CONFIGS,
    MIG_CONFIGS,
    Partition,
    table_slice_sizes,
    validate_config_table,
)

__all__ = ["DeviceProfile", "DEVICE_PROFILES", "device_profile"]


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """A MIG-capable device type: power curve + partition table."""

    name: str
    power: PowerModel
    configs: Mapping[int, Partition]
    default_config: int  # a sensible mixed layout valid for this table

    def __post_init__(self) -> None:
        # re-validates the table under this profile's name so a bad fleet
        # config fails with "<profile> table, config N ..." (not the bare
        # config id the table's import-time check reports)
        validate_config_table(
            dict(self.configs),
            max_slots=self.total_slots,
            max_memory_gb=max(p.total_memory_gb for p in self.configs.values()),
            name=self.name,
        )
        if self.default_config not in self.configs:
            raise AssertionError(
                f"{self.name} table, default config {self.default_config} "
                f"not in table ids {sorted(self.configs)}"
            )

    @property
    def total_slots(self) -> int:
        """Peak parallel compute slots (the full-GPU partition size)."""
        return max(p.total_slots for p in self.configs.values())

    @property
    def slice_sizes(self) -> Tuple[int, ...]:
        """Distinct slice widths this device can place (ascending)."""
        return table_slice_sizes(dict(self.configs))

    def config_ids(self) -> Tuple[int, ...]:
        """Valid partition ids of this device's table, ascending."""
        return tuple(sorted(self.configs))


DEVICE_PROFILES: Dict[str, DeviceProfile] = {
    p.name: p
    for p in [
        DeviceProfile("a100-250w", A100_250W, MIG_CONFIGS, default_config=3),
        DeviceProfile("a30-165w", A30_165W, A30_CONFIGS, default_config=2),
        DeviceProfile("tpu-v5e-pod", TPU_V5E_POD, MIG_CONFIGS, default_config=3),
    ]
}


def device_profile(name: str) -> DeviceProfile:
    """Look up a registered :class:`DeviceProfile` by name."""
    try:
        return DEVICE_PROFILES[name]
    except KeyError as e:
        raise KeyError(
            f"unknown device profile {name!r}; registered: {sorted(DEVICE_PROFILES)}"
        ) from e
