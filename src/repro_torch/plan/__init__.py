# The port's cascade plan layer (a numpy copy of repro.plan): one typed
# model of the cascade workload, compiled once per (bucket, batch, subset,
# rung) and consumed by the executors in repro_torch.core.engine and
# repro_torch.stream.engine.
from .ir import (CascadePlan, LevelPlan, LevelWavePlan,  # noqa: F401
                 SegmentPlan, SlotLayout, StreamStatePlan)
from .compiler import (CAP_FLOOR, BATCH_CAP_FLOOR,  # noqa: F401
                       STREAM_CAP_BASE, STREAM_DECODE_CAP,
                       compile_level_plan, compile_plan,
                       compile_stream_plan, dense_on_kernels,
                       level_capacities, n_compactions,
                       segment_spans, segment_work_units, select_backend,
                       select_head_mode,
                       shared_capacities, stream_budget, stream_capacity_rung,
                       validate_config, window_limits)
from .geometry import StreamGeometry, LevelSubset  # noqa: F401
