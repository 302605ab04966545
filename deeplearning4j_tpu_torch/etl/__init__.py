"""DataVec-equivalent ETL: readers, schema, transform DSL, local executor.

Reference: `datavec/datavec-api` (Schema/TransformProcess/RecordReader) +
`datavec-local` (LocalTransformExecutor) + `datavec-data-image`
(ImageRecordReader). Counterpart of ``deeplearning4j_tpu/etl/``: the same
names, classes and JSON. Host-side, vectorized into device tensors by
`datasets.record_iterator.RecordReaderDataSetIterator`.
"""
from .writable import ColumnType, parse_writable, is_missing, to_double
from .schema import Schema, SequenceSchema, ColumnMetaData, infer_schema
from .conditions import (Condition, ConditionOp, ColumnCondition,
                         NullWritableColumnCondition,
                         StringRegexColumnCondition,
                         InvalidValueColumnCondition, BooleanAnd, BooleanOr,
                         BooleanNot)
from .transforms import Transform
from .transform_process import (TransformProcess, Reducer, FilterStep,
                                ConvertToSequenceStep, ConvertFromSequenceStep)
from .executor import (LocalTransformExecutor, analyze_local,
                       analyze_quality_local, DataAnalysis,
                       DataQualityAnalysis)
from .join import Join, JoinType
from .image_transforms import (ImageTransform, ImageTransformProcess,
                               ResizeImageTransform, CropImageTransform,
                               RandomCropTransform, FlipImageTransform,
                               RotateImageTransform, ScaleImageTransform,
                               BoxImageTransform, ColorConversionTransform,
                               NormalizeImageTransform, MultiImageTransform,
                               PipelineImageTransform)
from .distributed import (ShardedTransformExecutor, shard_records,
                          shard_files)
from . import columnar
from .excel import ExcelRecordReader, ExcelRecordWriter
from .jdbc import JDBCRecordReader, RecordMetaDataJdbc
from .records import (InputSplit, FileSplit, CollectionInputSplit, StringSplit,
                      RecordReader, CSVRecordReader, LineRecordReader,
                      CollectionRecordReader, JacksonLineRecordReader,
                      SVMLightRecordReader, CSVSequenceRecordReader,
                      SequenceRecordReader, ImageRecordReader,
                      ParentPathLabelGenerator, CSVRecordWriter,
                      RecordMetaData)

__all__ = [n for n in dir() if not n.startswith("_")]
