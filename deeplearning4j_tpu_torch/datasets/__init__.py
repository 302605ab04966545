from .dataset import DataSet, MultiDataSet  # noqa: F401
from .iterators import (ArrayDataSetIterator, AsyncDataSetIterator,  # noqa: F401
                        BenchmarkDataSetIterator, DataSetIterator,
                        ListDataSetIterator, NativeBatchDataSetIterator)
from .record_iterator import (RecordReaderDataSetIterator,  # noqa: F401
                              SequenceRecordReaderDataSetIterator)
from .normalizers import (DataNormalization, NormalizerStandardize,  # noqa: F401
                          NormalizerMinMaxScaler, ImagePreProcessingScaler,
                          MultiNormalizer, NormalizerSerializer)
from .fetchers import (MnistDataFetcher, EmnistDataFetcher,  # noqa: F401
                       Cifar10Fetcher, MnistDataSetIterator,
                       EmnistDataSetIterator, Cifar10DataSetIterator,
                       IrisDataSetIterator, DigitsDataSetIterator, parse_idx)
