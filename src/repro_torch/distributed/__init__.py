# Distribution layer on one device: int8 gradient compression with error
# feedback, fault tolerance and straggler handling.  The sharding rules
# (the reference's ShardingRules / make_rules) and compressed_psum need a
# process group and come with the distributed slice.
from .compression import (CompressionState, init_compression,  # noqa: F401
                          compress_leaf, decompress_leaf, make_compressor)
from .fault import StragglerDetector, ElasticPlan, run_with_restarts  # noqa: F401
