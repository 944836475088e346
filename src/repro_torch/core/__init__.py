# Cascade detection, ported: cascade container, pyramid, integral images,
# feature oracle, grouping, and the Detector executors over compiled plans.
from .cascade import (Cascade, WINDOW, make_cascade, from_numpy,  # noqa: F401
                      save_cascade, load_cascade, paper_shaped_cascade,
                      PAPER_STAGE_SIZES)
from .integral import (CENTRE, integral_image, integral_images,  # noqa: F401
                       rect_sum, window_inv_sigma, integral_value)
from .engine import (Detector, EngineConfig, BatchResult,  # noqa: F401
                     LevelResult, calibrate_capacities)
from .pyramid import pyramid_plan, build_pyramid, downscale_nearest  # noqa: F401
from .nms import group_rectangles, group_rectangles_batch, iou_matrix  # noqa: F401
