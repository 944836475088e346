# Distribution layer: sharding rules (DP / TP / EP / SP + ZeRO) as DTensor
# placements, named-axis collectives, int8 gradient compression with error
# feedback (and its compressed all-reduce), fault tolerance and straggler
# handling.
from .sharding import ShardingRules, make_rules  # noqa: F401
from .compression import (CompressionState, init_compression,  # noqa: F401
                          compress_leaf, decompress_leaf, compressed_psum,
                          make_compressor)
from .fault import StragglerDetector, ElasticPlan, run_with_restarts  # noqa: F401
