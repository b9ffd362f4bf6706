"""checkpoint/ — asynchronous, crash-consistent checkpointing with
exact-step resume, pluggable storage and automatic recovery (counterpart of
``deeplearning4j_tpu/checkpoint/``, over the same zip and manifest).

- ``manager``  — CheckpointManager: finished host snapshot on the training
                 thread, async atomic journaled commits, retention,
                 triggers, ``restore_latest`` / ``restore_best`` with
                 fall-back past torn files, the early-stopping saver
                 protocol;
- ``manifest`` — the checksummed journal + atomic commit primitives that
                 make a torn write detectable through any backend;
- ``storage``  — the StorageBackend interface: LocalFSBackend (default),
                 ObjectStoreBackend (GCS-style put/get/list/delete) and
                 RetryingBackend (bounded exponential-backoff-with-jitter
                 retries + per-op timeouts for transient faults);
- ``resume``   — ``train_until``: the auto-resume driver looping
                 restore_latest + fit under a restart budget;
- ``faults``   — the chaos harness: FaultInjector (step / epoch-boundary /
                 probabilistic kills, as exceptions or a real SIGKILL),
                 FlakyBackend (seeded storage faults + latency),
                 tear/flip corruption simulators;
- ``cloud``    — CloudObjectBackend: an S3-dialect client over
                 ``http.client`` (signed requests, bounded reads, multipart
                 with abort on failure, paged listing, HTTP status mapped
                 onto the storage error taxonomy) and ``backend_from_url``;
- ``emulator`` — ObjectStoreEmulator: the fault-scripted HTTP object
                 store it is tested against (latency, status bursts with
                 ``Retry-After``, mid-transfer disconnects, bit rot);
- ``cache``    — CachedBackend: a disk LRU over any backend, sha256 checked
                 on every read, single-flight fills;
- ``sharded``  — shard sets with N→M reshard-on-restore and ``state_sha``;
- ``supervisor`` — ``train_until_process``: the same restart loop with a
                 fresh OS process an attempt (real SIGKILLs, hangs, the
                 elastic-restart exit code).

Wired end to end as ``fit(..., checkpoint_manager=cm)`` on
MultiLayerNetwork and ComputationGraph.
"""

from deeplearning4j_tpu_torch.checkpoint.manager import (  # noqa: F401
    CheckpointError,
    CheckpointManager,
    ResumeState,
    consume_resume_state,
)
from deeplearning4j_tpu_torch.checkpoint.faults import (  # noqa: F401
    FaultInjector,
    FlakyBackend,
    SimulatedCrash,
    flip_byte,
    flip_object_byte,
    tear_file,
    tear_object,
)
from deeplearning4j_tpu_torch.checkpoint.manifest import (  # noqa: F401
    ManifestError,
    file_sha256,
    load_manifest,
    scan_checkpoint_files,
)
from deeplearning4j_tpu_torch.checkpoint.storage import (  # noqa: F401
    LocalFSBackend,
    ObjectStoreBackend,
    PermanentStorageError,
    RetryingBackend,
    StorageBackend,
    StorageError,
    StorageNotFoundError,
    TransientStorageError,
    as_backend,
    is_orphan_key,
    sweep_orphan_keys,
)
from deeplearning4j_tpu_torch.checkpoint.cloud import (  # noqa: F401
    CloudCredentials,
    CloudObjectBackend,
    backend_from_url,
)
from deeplearning4j_tpu_torch.checkpoint.cache import (  # noqa: F401
    CachedBackend,
)
from deeplearning4j_tpu_torch.checkpoint.emulator import (  # noqa: F401
    ObjectStoreEmulator,
)
from deeplearning4j_tpu_torch.checkpoint.resume import (  # noqa: F401
    CrashRecord,
    RestartBudgetExceeded,
    RestartPolicy,
    RunSummary,
    train_until,
)
from deeplearning4j_tpu_torch.checkpoint.sharded import (  # noqa: F401
    ShardedCheckpointError,
    restore_sharded,
    scan_shard_sets,
    shard_snapshot,
    simulated_shard_snapshots,
    state_sha,
)
from deeplearning4j_tpu_torch.checkpoint.supervisor import (  # noqa: F401
    ELASTIC_RESTART_EXIT,
    ProcessCrashRecord,
    ProcessRunSummary,
    train_until_process,
)
