"""Datasets of the port (counterpart of ``deeplearning4j_tpu/datasets``):
DataSet / MultiDataSet holders, the fetchers and their iterators, the
async and adapter iterators, pre-processors, record readers and the shard
sources, the sharded lease-based reader, on-device augmentation and the
push-driven streaming iterator. Every iterator, reader and fetcher yields
the JAX package's arrays for the same arguments and seed."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.fetchers import (cifar10_data, emnist_data, iris_data,
                                                        lfw_data, mnist_data, svhn_data,
                                                        synthetic_images, synthetic_mnist,
                                                        tiny_imagenet_data)
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator, AsyncMultiDataSetIterator, CifarDataSetIterator, DataSetIterator,
    EarlyTerminationDataSetIterator, EarlyTerminationMultiDataSetIterator,
    EmnistDataSetIterator, ExistingDataSetIterator, IrisDataSetIterator,
    IteratorDataSetIterator, JointMultiDataSetIterator, LFWDataSetIterator,
    ListDataSetIterator, ListMultiDataSetIterator, MnistDataSetIterator,
    MultiDataSetIterator, MultiDataSetIteratorAdapter, MultiDataSetWrapperIterator,
    MultipleEpochsIterator, SamplingDataSetIterator, SvhnDataSetIterator,
    TinyImageNetDataSetIterator)
from deeplearning4j_tpu_torch.datasets.preprocessing import (CombinedPreProcessor,
                                                             DataSetPreProcessor,
                                                             ImagePreProcessingScaler,
                                                             NormalizerMinMaxScaler,
                                                             NormalizerStandardize)
from deeplearning4j_tpu_torch.datasets.records import (CollectionRecordReader, CSVRecordReader,
                                                       CSVSequenceRecordReader, CSVShardSource,
                                                       RecordReader,
                                                       RecordReaderDataSetIterator,
                                                       RecordSource,
                                                       SequenceRecordReaderDataSetIterator,
                                                       ShardFileSource, write_shards)
from deeplearning4j_tpu_torch.datasets.sharded import (DataLeaseError, DataLeaseTimeout,
                                                       LedgerReport, ShardedDataset,
                                                       ShardedReader, ShardLeaseBoard,
                                                       StaleDataLeaseError, reconcile_ledger)
from deeplearning4j_tpu_torch.datasets.augment import ImageAugmentation
from deeplearning4j_tpu_torch.datasets.streaming import (StreamingDataSetIterator,
                                                         StreamingHttpReceiver)

__all__ = [
    "DataSet", "MultiDataSet", "synthetic_mnist", "synthetic_images", "iris_data",
    "mnist_data", "cifar10_data", "emnist_data", "svhn_data", "tiny_imagenet_data",
    "lfw_data", "DataSetIterator", "ListDataSetIterator", "AsyncDataSetIterator",
    "IrisDataSetIterator", "MnistDataSetIterator", "EarlyTerminationDataSetIterator",
    "CifarDataSetIterator", "EmnistDataSetIterator", "SvhnDataSetIterator",
    "TinyImageNetDataSetIterator", "LFWDataSetIterator", "ExistingDataSetIterator",
    "IteratorDataSetIterator", "SamplingDataSetIterator", "MultipleEpochsIterator",
    "MultiDataSetIterator", "ListMultiDataSetIterator", "MultiDataSetIteratorAdapter",
    "MultiDataSetWrapperIterator", "JointMultiDataSetIterator", "AsyncMultiDataSetIterator",
    "EarlyTerminationMultiDataSetIterator", "DataSetPreProcessor", "NormalizerStandardize",
    "NormalizerMinMaxScaler", "ImagePreProcessingScaler", "CombinedPreProcessor",
    "RecordReader", "CollectionRecordReader", "CSVRecordReader", "CSVSequenceRecordReader",
    "CSVShardSource", "RecordReaderDataSetIterator", "RecordSource",
    "SequenceRecordReaderDataSetIterator", "ShardFileSource", "write_shards",
    "DataLeaseError", "DataLeaseTimeout", "StaleDataLeaseError", "ShardedDataset",
    "ShardedReader", "ShardLeaseBoard", "LedgerReport", "reconcile_ledger",
    "ImageAugmentation", "StreamingDataSetIterator", "StreamingHttpReceiver",
]
