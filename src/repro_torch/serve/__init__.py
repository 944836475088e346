# The detection service, ported: the micro-batching DetectorService over the
# port's Detector and stream sessions, the multi-tenant fleet scheduler on
# top of it, and their typed stats.  The reference's LM serving steps
# (serve/serve_step.py) belong to the LM stack, not ported yet.
from .detector_service import (DetectorService, ServiceConfig,  # noqa: F401
                               Request, DetectionRequest, FrameRequest,
                               StreamSession, PodSpec, SLO_TIERS, GOVERNORS)
from .stats import (SCHEMA_VERSION, ServiceStats, EnergyStats,  # noqa: F401
                    StreamStats, FleetStats, PodStats, TailStats,
                    EnergyPodStats, DecisionStats)
from .fleet import FleetConfig, FleetScheduler, FleetSession  # noqa: F401
