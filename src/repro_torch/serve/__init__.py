# Serving: the LM serving steps (batched prefill, decode, cascade early-exit
# decode, generation) over ``repro_torch.models``; the micro-batching
# DetectorService over the port's Detector and stream sessions, the
# multi-tenant fleet scheduler on top of it, and their typed stats.
from .serve_step import (make_prefill_step, make_decode_step,  # noqa: F401
                         make_cascade_decode_step, generate)
from .detector_service import (DetectorService, ServiceConfig,  # noqa: F401
                               Request, DetectionRequest, FrameRequest,
                               StreamSession, PodSpec, SLO_TIERS, GOVERNORS)
from .stats import (SCHEMA_VERSION, ServiceStats, EnergyStats,  # noqa: F401
                    StreamStats, FleetStats, PodStats, TailStats,
                    EnergyPodStats, DecisionStats)
from .fleet import FleetConfig, FleetScheduler, FleetSession  # noqa: F401
