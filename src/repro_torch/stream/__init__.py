# Streaming video detection, ported: temporal tile-reuse over the port's
# Detector (the host planner, the packed incremental engine with its
# device-resident step, VideoDetector and the synthetic video corpus).
from .tiles import (tile_grid_shape, tile_change_scores,  # noqa: F401
                    dilate_tiles, changed_window_mask)
from .engine import (StreamEngine, StreamGeometry,  # noqa: F401
                     StreamState, StreamStepOut)
from .video import (StreamConfig, FrameStats, FramePlan,  # noqa: F401
                    VideoDetector, level_windows_from_raw)
from .synthetic import make_video, SCENARIOS  # noqa: F401
