# Cascade training, ported: the procedural corpus (numpy, bit-equal to the
# reference's draws) and AdaBoost stump search in plain PyTorch.
from .data import (FaceCorpus, make_face, make_background, make_decoy,  # noqa: F401
                   render_scene, sample_negative, window_dataset)
from .adaboost import train_cascade, TrainConfig  # noqa: F401
