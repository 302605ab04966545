"""RecordReaders / writers / input splits.

Reference: `datavec/datavec-api/src/main/java/org/datavec/api/records/reader/RecordReader.java`
(:168 interface) and impls under `records/reader/impl/` — `csv/CSVRecordReader`,
`LineRecordReader`, `collection/CollectionRecordReader`,
`misc/SVMLightRecordReader`, `jackson/JacksonLineRecordReader`,
`csv/CSVSequenceRecordReader`; image:
`datavec-data-image/.../ImageRecordReader.java` with
`ParentPathLabelGenerator`. Splits: `api/split/FileSplit.java`,
`CollectionInputSplit`.
"""
from __future__ import annotations

import csv as _csv
import glob as _glob
import io
import json
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# input splits
# ---------------------------------------------------------------------------
class InputSplit:
    def locations(self) -> List[str]:
        raise NotImplementedError


class FileSplit(InputSplit):
    """Root dir (recursive) or single file, optionally extension-filtered and
    shuffled (reference `split/FileSplit.java`)."""

    def __init__(self, root: str, allowed_extensions: Sequence[str] = None,
                 rng_seed: Optional[int] = None):
        self.root = root
        self.allowed = tuple(e.lower().lstrip(".")
                             for e in allowed_extensions) \
            if allowed_extensions else None
        self.rng_seed = rng_seed

    def locations(self) -> List[str]:
        if os.path.isfile(self.root):
            files = [self.root]
        else:
            files = sorted(
                p for p in _glob.glob(os.path.join(self.root, "**", "*"),
                                      recursive=True)
                if os.path.isfile(p))
        if self.allowed is not None:
            files = [f for f in files
                     if f.rsplit(".", 1)[-1].lower() in self.allowed]
        if self.rng_seed is not None:
            rng = np.random.RandomState(self.rng_seed)
            files = list(np.array(files)[rng.permutation(len(files))])
        return files


class CollectionInputSplit(InputSplit):
    def __init__(self, uris: Sequence[str]):
        self._uris = list(uris)

    def locations(self):
        return list(self._uris)


class StringSplit(InputSplit):
    """A single in-memory string as the data source."""

    def __init__(self, data: str):
        self.data = data

    def locations(self):
        return []


# ---------------------------------------------------------------------------
# record readers
# ---------------------------------------------------------------------------
class RecordMetaData:
    """Provenance of one record (reference `records/metadata/RecordMetaData`)."""

    def __init__(self, uri: str, position: int):
        self.uri = uri
        self.position = position

    def __repr__(self):
        return f"RecordMetaData({self.uri}:{self.position})"


class RecordReader:
    """Iterator over records = lists of values."""

    def initialize(self, split: InputSplit):
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> List:
        raise NotImplementedError

    def next_with_meta(self):
        return self.next(), RecordMetaData("", -1)

    def reset(self):
        raise NotImplementedError

    def get_labels(self) -> Optional[List[str]]:
        return None

    def __iter__(self) -> Iterator[List]:
        self.reset()
        while self.has_next():
            yield self.next()

    def close(self):
        pass


class _ListBackedReader(RecordReader):
    def __init__(self):
        self._records: List[List] = []
        self._i = 0
        self._metas: List[RecordMetaData] = []

    def has_next(self):
        return self._i < len(self._records)

    def next(self):
        r = self._records[self._i]
        self._i += 1
        return r

    def next_with_meta(self):
        m = self._metas[self._i] if self._i < len(self._metas) \
            else RecordMetaData("", self._i)
        return self.next(), m

    def reset(self):
        self._i = 0


class CSVRecordReader(_ListBackedReader):
    """Reference `impl/csv/CSVRecordReader.java` — configurable skip lines,
    delimiter, quote char. Values stay strings; typing happens via Schema /
    TransformProcess (matching reference Text-writable behavior)."""

    def __init__(self, skip_num_lines: int = 0, delimiter: str = ",",
                 quote: str = '"'):
        super().__init__()
        self.skip = skip_num_lines
        self.delimiter = delimiter
        self.quote = quote

    def initialize(self, split: InputSplit):
        self._records, self._metas = [], []
        if isinstance(split, StringSplit):
            self._parse(io.StringIO(split.data), "<string>")
        else:
            for path in split.locations():
                with open(path, "r", newline="") as f:
                    self._parse(f, path)
        self.reset()
        return self

    def _parse(self, f, uri):
        # Records stay text-typed (Schema/TransformProcess do the typing),
        # so parsing here is Python csv; the NUMERIC fast path is the C++
        # parser in `deeplearning4j_tpu_torch.native.read_csv`, used by
        # NativeBatchDataSetIterator / fetchers where matrices are wanted.
        reader = _csv.reader(f, delimiter=self.delimiter,
                             quotechar=self.quote)
        for i, row in enumerate(reader):
            if i < self.skip or not row:
                continue
            self._records.append(row)
            self._metas.append(RecordMetaData(uri, i))


class LineRecordReader(_ListBackedReader):
    """One record per line, single String column."""

    def initialize(self, split: InputSplit):
        self._records, self._metas = [], []
        if isinstance(split, StringSplit):
            lines = split.data.splitlines()
            for i, ln in enumerate(lines):
                self._records.append([ln])
                self._metas.append(RecordMetaData("<string>", i))
        else:
            for path in split.locations():
                with open(path, "r") as f:
                    for i, ln in enumerate(f):
                        self._records.append([ln.rstrip("\n")])
                        self._metas.append(RecordMetaData(path, i))
        self.reset()
        return self


class CollectionRecordReader(_ListBackedReader):
    """In-memory records (reference `impl/collection/CollectionRecordReader`)."""

    def __init__(self, records: Sequence[Sequence]):
        super().__init__()
        self._records = [list(r) for r in records]

    def initialize(self, split=None):
        self.reset()
        return self


class JacksonLineRecordReader(_ListBackedReader):
    """JSON-object-per-line (reference `impl/jackson/JacksonLineRecordReader`).
    Field order comes from ``field_selection``."""

    def __init__(self, field_selection: Sequence[str]):
        super().__init__()
        self.fields = list(field_selection)

    def initialize(self, split: InputSplit):
        self._records, self._metas = [], []
        sources = [("<string>", io.StringIO(split.data))] \
            if isinstance(split, StringSplit) \
            else [(p, open(p)) for p in split.locations()]
        for uri, f in sources:
            with f:
                for i, ln in enumerate(f):
                    if not ln.strip():
                        continue
                    obj = json.loads(ln)
                    self._records.append([obj.get(k) for k in self.fields])
                    self._metas.append(RecordMetaData(uri, i))
        self.reset()
        return self


class SVMLightRecordReader(_ListBackedReader):
    """`label idx:val idx:val ...` sparse format
    (reference `impl/misc/SVMLightRecordReader.java`)."""

    def __init__(self, num_features: int, zero_based: bool = False):
        super().__init__()
        self.num_features = num_features
        self.zero_based = zero_based

    def initialize(self, split: InputSplit):
        self._records, self._metas = [], []
        sources = [("<string>", io.StringIO(split.data))] \
            if isinstance(split, StringSplit) \
            else [(p, open(p)) for p in split.locations()]
        for uri, f in sources:
            with f:
                for i, ln in enumerate(f):
                    ln = ln.split("#")[0].strip()
                    if not ln:
                        continue
                    parts = ln.split()
                    label = float(parts[0])
                    feats = [0.0] * self.num_features
                    for tok in parts[1:]:
                        idx, val = tok.split(":")
                        j = int(idx) - (0 if self.zero_based else 1)
                        feats[j] = float(val)
                    self._records.append(feats + [label])
                    self._metas.append(RecordMetaData(uri, i))
        self.reset()
        return self


# ---------------------------------------------------------------------------
# sequence readers
# ---------------------------------------------------------------------------
class SequenceRecordReader(RecordReader):
    """next() returns a sequence: list of timestep rows."""


class CSVSequenceRecordReader(SequenceRecordReader, _ListBackedReader):
    """One CSV file per sequence (reference
    `impl/csv/CSVSequenceRecordReader.java`)."""

    def __init__(self, skip_num_lines: int = 0, delimiter: str = ","):
        _ListBackedReader.__init__(self)
        self.skip = skip_num_lines
        self.delimiter = delimiter

    def initialize(self, split: InputSplit):
        self._records, self._metas = [], []
        for path in split.locations():
            with open(path, "r", newline="") as f:
                rows = [r for i, r in enumerate(
                    _csv.reader(f, delimiter=self.delimiter))
                    if i >= self.skip and r]
            self._records.append(rows)
            self._metas.append(RecordMetaData(path, 0))
        self.reset()
        return self


# ---------------------------------------------------------------------------
# image reader
# ---------------------------------------------------------------------------
class ParentPathLabelGenerator:
    """Label = name of the file's parent directory (reference
    `datavec-data-image/.../ParentPathLabelGenerator.java`)."""

    def label_for(self, path: str) -> str:
        return os.path.basename(os.path.dirname(path))


class ImageRecordReader(RecordReader):
    """Decode images to CHW float arrays + integer label
    (reference `ImageRecordReader.java` — NativeImageLoader resize +
    channel handling; here PIL + numpy, with the native decode path in
    `runtime/` when built)."""

    def __init__(self, height: int, width: int, channels: int = 3,
                 label_generator: Optional[ParentPathLabelGenerator] = None,
                 image_transform=None, seed: Optional[int] = None):
        self.height, self.width, self.channels = height, width, channels
        self.label_gen = label_generator
        #: optional ImageTransform/ImageTransformProcess applied per image
        #: (reference ImageRecordReader's imageTransform constructor arg)
        self.image_transform = image_transform
        self._rng = np.random.RandomState(seed)
        self._files: List[str] = []
        self._labels: List[str] = []
        self._i = 0

    def initialize(self, split: InputSplit):
        self._files = split.locations()
        if self.label_gen is not None:
            self._labels = sorted(
                {self.label_gen.label_for(f) for f in self._files})
        self._i = 0
        return self

    def get_labels(self):
        return list(self._labels) if self.label_gen else None

    def has_next(self):
        return self._i < len(self._files)

    def next(self):
        from PIL import Image
        path = self._files[self._i]
        self._i += 1
        img = Image.open(path)
        if self.channels == 1:
            img = img.convert("L")
        else:
            img = img.convert("RGB")
        img = img.resize((self.width, self.height))
        arr = np.asarray(img, dtype=np.float32)
        if arr.ndim == 2:
            arr = arr[None, :, :]
        else:
            arr = arr.transpose(2, 0, 1)  # HWC -> CHW
        if self.image_transform is not None:
            tf = self.image_transform
            arr = (tf.execute(arr, self._rng) if hasattr(tf, "execute")
                   else tf.transform(arr, self._rng))
        rec = [arr]
        if self.label_gen is not None:
            rec.append(self._labels.index(
                self.label_gen.label_for(path)))
        return rec

    def next_with_meta(self):
        path = self._files[self._i]
        return self.next(), RecordMetaData(path, 0)

    def reset(self):
        self._i = 0


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------
class CSVRecordWriter:
    """Reference `records/writer/impl/csv/CSVRecordWriter.java`."""

    def __init__(self, path: str, delimiter: str = ","):
        self.path = path
        self.delimiter = delimiter
        self._f = open(path, "w", newline="")
        self._w = _csv.writer(self._f, delimiter=delimiter)

    def write(self, record: Sequence):
        self._w.writerow(record)

    def write_all(self, records: Sequence[Sequence]):
        for r in records:
            self.write(r)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
