"""Online serving of the port (counterpart of ``hydragnn_tpu/serve``).

``DynamicBatcher`` first-fit-fills incoming graphs into the fitted
``PackSpec`` budget shapes under a latency deadline, ``ServingEngine``
serves the dispatched bins through one warmed executable per budget (a
replayed CUDA graph on a card) with double-buffered transfers, and the
admission gate refuses a snapshot with non-finite weights. The fleet
tier, ``ServingTier``, replicates N engines behind a ``Router`` with
least-loaded / spec-affinity dispatch, deadline-class load shedding,
zero-downtime snapshot rollover and dead-replica re-route.
"""

from hydragnn_tpu_torch.serve.admission import AdmissionError, admit_state
from hydragnn_tpu_torch.serve.batcher import DynamicBatcher, ServeRequest
from hydragnn_tpu_torch.serve.engine import (
    ServingEngine,
    ServingSettings,
    serving_settings,
)
from hydragnn_tpu_torch.serve.fleet import (
    FleetSettings,
    ReplicaHandle,
    ServingTier,
    fleet_settings,
)
from hydragnn_tpu_torch.serve.router import (
    DEADLINE_CLASSES,
    ROUTER_POLICIES,
    FleetRequest,
    Router,
)

__all__ = [
    "AdmissionError",
    "admit_state",
    "DynamicBatcher",
    "ServeRequest",
    "ServingEngine",
    "ServingSettings",
    "serving_settings",
    "DEADLINE_CLASSES",
    "ROUTER_POLICIES",
    "FleetRequest",
    "Router",
    "FleetSettings",
    "ReplicaHandle",
    "ServingTier",
    "fleet_settings",
]
