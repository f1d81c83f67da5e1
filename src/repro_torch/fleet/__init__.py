"""Fleet-scale MIG simulation: N heterogeneous GPUs behind one dispatcher.

The paper (§IV-§V) schedules a single MIG-capable GPU; a production fleet
routes traffic across many of them.  This package adds that layer without
touching the per-GPU physics: a pluggable dispatcher splits the arrival
stream (:mod:`repro_torch.fleet.dispatch`), each device runs the unchanged
event-driven :class:`~repro_torch.core.simulator.MIGSimulator` with its own power
curve and partition table (:mod:`repro_torch.fleet.devices`), and the per-device
results are aggregated into fleet-level ET/energy/tardiness metrics
(:mod:`repro_torch.fleet.simulator`).

A 1-device fleet is bit-identical to the single-MIG paper path.

The port's own copy of ``repro.fleet``: float64 host code with the
reference's order of operations and tie-breaks, so the same fleet, jobs and
policies give the same results (the checked-in ``fleet_scaling``,
``dispatchers`` and ``serving_matrix`` rows replay through
:func:`repro_torch.sweep.cells.run_cell`).  The only device work is a
registry DQN's Q network, one per fleet member.
"""

from repro_torch.fleet.devices import DEVICE_PROFILES, DeviceProfile, device_profile
from repro_torch.fleet.dispatch import (
    DISPATCHERS,
    DeviceLoadState,
    DeviceState,
    DispatchContext,
    Dispatcher,
    EngineDeviceState,
    FragmentationAwareDispatcher,
    StateAwareDispatcher,
    as_context_dispatcher,
    dispatch_jobs,
    make_dispatcher,
)
from repro_torch.fleet.simulator import (
    DISPATCH_INFO_MODES,
    DeviceAdaptedPolicy,
    FleetDeviceSpec,
    FleetResult,
    FleetSimulator,
    FleetSpec,
    FleetStream,
    FleetView,
    aggregate_sim_results,
)

__all__ = [
    "DEVICE_PROFILES",
    "DeviceAdaptedPolicy",
    "DeviceProfile",
    "device_profile",
    "DISPATCHERS",
    "DeviceLoadState",
    "DeviceState",
    "DispatchContext",
    "Dispatcher",
    "EngineDeviceState",
    "FragmentationAwareDispatcher",
    "StateAwareDispatcher",
    "as_context_dispatcher",
    "dispatch_jobs",
    "make_dispatcher",
    "DISPATCH_INFO_MODES",
    "FleetDeviceSpec",
    "FleetResult",
    "FleetSimulator",
    "FleetSpec",
    "FleetStream",
    "FleetView",
    "aggregate_sim_results",
]
