# Asymmetry-aware task scheduling + energy optimization (paper §6–§7), the
# port of repro.scheduling: plain Python and numpy, the same names, tables
# and results; autotune runs the port's Detector on a chosen device.
#   dag       — detection-task DAG (Fig. 19) with a calibrated work model
#   executor  — discrete-event simulator of asymmetric multicore platforms
#   botlev    — criticality-aware scheduler (Chronaki et al., the paper's §7.1)
#   heft      — HEFT static baseline
#   policies  — omp-static / dynamic-greedy / rate-weighted baselines
#   energy    — calibrated power model (Odroid XU4, RPi 3B+, the reference's
#               modelled pod)
#   dvfs      — cluster-frequency optimizer (Figs 21–24, Table I)
#   autotune  — step/scaleFactor accuracy-constrained sweep (Fig 20)
#   hetero    — heterogeneous-pod work partitioner (serving pods)
from .dag import Task, TaskDAG, build_detection_dag, WorkModel  # noqa: F401
from .executor import simulate, SimResult, Core  # noqa: F401
from .botlev import BotlevScheduler  # noqa: F401
from .heft import HEFTScheduler  # noqa: F401
from .policies import (FIFOScheduler, StaticBlockScheduler,  # noqa: F401
                       SequentialScheduler)
from .energy import (Platform, CorePowerModel, odroid_xu4, rpi3b,  # noqa: F401
                     tpu_v5e_pod, EXYNOS_BIG_FREQS, EXYNOS_LITTLE_FREQS,
                     PodOperatingPoint, pod_operating_points, parked_point,
                     EnergyAccount)
from .dvfs import (DVFSPoint, dvfs_sweep, optimal_operating_point,  # noqa: F401
                   GovernorDecision, binding_slo, evaluate_operating_points,
                   select_operating_points)
from .autotune import (SweepCell, accuracy_sweep, error_table,  # noqa: F401
                       match_detections)
from .hetero import (rate_weighted_split, HeteroPodPlan,  # noqa: F401
                     mixed_pod_platform, replan_on_straggle,
                     update_rates_ema)
