"""The parallel tier of the port: serving (``ParallelInference``),
data-parallel and elastic training over ``torch.distributed``
(``ParallelWrapper``, ``ClusterTrainer``, ``ElasticWorker``), gradient
compression, the collective watchdog, meshes of ranks and input sharding.

Model and sequence parallelism (``GPipeTrainer``, ``make_pipeline_mesh``,
``pipeline_apply``, ``ulysses_self_attention``, ``ring_self_attention``)
wait for ROADMAP §A6b."""

from deeplearning4j_tpu_torch.parallel.compress import (GradientCompression,
                                                        Int8Compression,
                                                        OneBitCompression,
                                                        ThresholdCompression,
                                                        TopKCompression,
                                                        compression_stats,
                                                        enable_grad_compression,
                                                        ensure_compress_state,
                                                        measure_compression_overhead)
from deeplearning4j_tpu_torch.parallel.elastic import (ElasticError,
                                                       ElasticRestartRequired,
                                                       ElasticRunSummary, ElasticRuntime,
                                                       ElasticWorker, GenerationRecord,
                                                       LeaseBoard, Membership, Rendezvous,
                                                       RendezvousTimeout,
                                                       StaleGenerationError)
from deeplearning4j_tpu_torch.parallel.inference import (DeadlineExpiredError,
                                                         ParallelInference,
                                                         QueueFullError)
from deeplearning4j_tpu_torch.parallel.mesh import data_sharding, make_mesh, replicated
from deeplearning4j_tpu_torch.parallel.ring_attention import (flash_self_attention,
                                                              reference_attention)
from deeplearning4j_tpu_torch.parallel.sharding import (ShardIterator, UnequalShardError,
                                                        check_equal_local_shards,
                                                        shard_dataset_rows, shard_directory,
                                                        shard_files, shard_iterator)
from deeplearning4j_tpu_torch.parallel.stats import TrainingStats
from deeplearning4j_tpu_torch.parallel.trainer import (ClusterTrainer,
                                                       EarlyStoppingParallelTrainer,
                                                       ParallelWrapper)
from deeplearning4j_tpu_torch.parallel.watchdog import (CollectiveTimeoutError,
                                                        CollectiveWatchdog)

__all__ = [
    "make_mesh", "data_sharding", "replicated",
    "ClusterTrainer", "EarlyStoppingParallelTrainer", "ParallelWrapper",
    "DeadlineExpiredError", "ParallelInference", "QueueFullError",
    "ShardIterator", "UnequalShardError", "check_equal_local_shards",
    "shard_dataset_rows", "shard_directory", "shard_files", "shard_iterator",
    "ElasticError", "ElasticRestartRequired", "ElasticRunSummary", "ElasticRuntime",
    "ElasticWorker", "GenerationRecord", "LeaseBoard", "Membership", "Rendezvous",
    "RendezvousTimeout", "StaleGenerationError",
    "GradientCompression", "Int8Compression", "OneBitCompression",
    "ThresholdCompression", "TopKCompression", "compression_stats",
    "enable_grad_compression", "ensure_compress_state", "measure_compression_overhead",
    "TrainingStats", "CollectiveTimeoutError", "CollectiveWatchdog",
    "flash_self_attention", "reference_attention",
]
