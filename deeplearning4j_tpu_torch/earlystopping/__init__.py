from deeplearning4j_tpu_torch.earlystopping.trainer import (  # noqa: F401
    EarlyStoppingConfiguration,
    EarlyStoppingTrainer,
    EarlyStoppingResult,
)
from deeplearning4j_tpu_torch.earlystopping.conditions import (  # noqa: F401
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
    InvalidScoreIterationTerminationCondition,
)
from deeplearning4j_tpu_torch.earlystopping.savers import (  # noqa: F401
    InMemoryModelSaver,
    LocalFileModelSaver,
)
