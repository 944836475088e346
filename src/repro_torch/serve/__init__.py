# The detection service, ported: the micro-batching DetectorService over the
# port's Detector and stream sessions, and its typed stats.  The reference's
# fleet scheduler (serve/fleet.py) and LM serving steps (serve/serve_step.py)
# are not ported yet.
from .detector_service import (DetectorService, ServiceConfig,  # noqa: F401
                               Request, DetectionRequest, FrameRequest,
                               StreamSession, PodSpec, SLO_TIERS, GOVERNORS)
from .stats import (SCHEMA_VERSION, ServiceStats, EnergyStats,  # noqa: F401
                    StreamStats, FleetStats, PodStats, TailStats,
                    EnergyPodStats, DecisionStats)
