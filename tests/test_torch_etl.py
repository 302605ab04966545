"""The port's ``etl/`` against the JAX package's, on the same inputs.

Every case runs once on each side and compares plain Python values: the
records a process gives, its JSON and its final schema's JSON, the
analyses, what each reader and writer reads back, and the image arrays.
Both sides do the same float64 Python arithmetic and the same numpy and
PIL calls on the same inputs, so everything is held equal exactly (no
tolerance). The JSON of a process names its classes by ``@class``: the
strings must be equal, and each side must read the other's.
"""
import dataclasses
import json
import os
import sqlite3
import zipfile

import numpy as np
import pytest

import deeplearning4j_tpu.etl as J
import deeplearning4j_tpu_torch.etl as T
from deeplearning4j_tpu.etl import transforms as jtr
from deeplearning4j_tpu_torch.etl import distributed as tdist
from deeplearning4j_tpu_torch.etl import transforms as ttr

SIDES = {J: jtr, T: ttr}

ROWS = [
    ["alice", "SF", 30, 1.5, "2024-06-15 13:45:00"],
    ["bob", "NYC", 40, 2.5, "2023-01-02 03:04:05"],
    ["carol", "LA", 25, 3.5, "2022-12-31 23:59:59"],
    [" dave ", "SF", 35, 4.5, "2021-07-04 12:00:00"],
    ["eve", "LA", None, None, "2020-02-29 00:00:01"],
]


def _schema(E):
    return (E.Schema.Builder()
            .add_column_string("name")
            .add_column_categorical("city", ["SF", "NYC", "LA"])
            .add_column_integer("age", min_value=0, max_value=38)
            .add_column_double("score")
            .add_column_string("ts")
            .build())


def _cond(E, op, value=None, value_set=None, column="age"):
    return E.ColumnCondition(column, E.ConditionOp(op), value, value_set)


#: builder chains over ``_schema`` and ``ROWS``: together they take every
#: builder method, transform, condition, reduce op and sequence step
PROCESSES = {
    "columns": lambda E, b: (
        b.remove_columns("ts").rename_column("score", "points")
        .reorder_columns("points", "age").duplicate_column("age", "age2")
        .add_constant_column("k", "Integer", 7)
        .remove_all_columns_except("points", "age", "name", "k")),
    "convert": lambda E, b: (
        b.replace_empty_with_value("age", 0).convert_to_double("age")
        .replace_empty_with_value("score", -1.0).convert_to_integer("score")
        .convert_to_string("score")),
    "categorical": lambda E, b: (
        b.categorical_to_integer("city").integer_to_categorical(
            "city", ["x", "y", "z"]).categorical_to_one_hot("city")
        .string_to_categorical("name", ["alice", "bob", "carol", " dave ",
                                        "eve"])
        .categorical_to_integer("name")),
    "math": lambda E, b: (
        b.replace_empty_with_value("age", 33)
        .replace_empty_with_value("score", 0.25)
        .double_math_op("score", "Multiply", 2.0)
        .integer_math_op("age", "Add", 1)
        .double_math_op("score", "Modulus", 3.0)
        .double_math_op("score", "ReverseSubtract", 10.0)
        .double_math_op("score", "ReverseDivide", 1.0)
        .double_math_op("score", "ScalarMax", 0.2)
        .double_math_function("score", "LOG")
        .double_math_function("score", "ABS")
        .double_columns_math_op("sum", "Add", "age", "score")
        .double_columns_math_op("prod", "Multiply", "age", "score")
        .double_columns_math_op("lo", "Min", "age", "score")
        .double_columns_math_op("hi", "Max", "age", "score")
        .double_columns_math_op("diff", "Subtract", "age", "score")
        .double_columns_math_op("ratio", "Divide", "age", "score")),
    "math_functions": lambda E, b: (
        b.replace_empty_with_value("score", 0.5)
        .duplicate_column("score", "s2").duplicate_column("score", "s3")
        .duplicate_column("score", "s4").duplicate_column("score", "s5")
        .double_math_function("score", "EXP")
        .double_math_function("s2", "SQRT").double_math_function("s3", "SIN")
        .double_math_function("s4", "CEIL")
        .double_math_function("s5", "SIGNUM")),
    "conditional": lambda E, b: (
        b.conditional_replace_value_transform(
            "age", 0, _cond(E, "GreaterOrEqual", 35))
        .conditional_copy_value_transform(
            "name", "city", _cond(E, "Equal", "LA", column="city"))
        .replace_invalid_with_value("age", -1)),
    "strings": lambda E, b: (
        b.remove_white_space("name")
        .append_string_column_transform("name", "_x")
        .string_map_transform("city", {"SF": "San Francisco"})
        .replace_string_transform("name", {"_x": "!"})
        .change_case("name", "UPPER")
        .concatenate_string_columns("full", "-", "name", "city")),
    "time": lambda E, b: (
        b.string_to_time("ts", "%Y-%m-%d %H:%M:%S")
        .derive_columns_from_time("ts", ["YEAR", "MONTH", "DAY", "HOUR",
                                         "MINUTE", "SECOND",
                                         "DAY_OF_WEEK"])),
    "filter_ops": lambda E, b: (
        b.filter(_cond(E, "LessThan", 26)).filter(_cond(E, "LessOrEqual", 25))
        .filter(_cond(E, "GreaterThan", 39))
        .filter(_cond(E, "NotEqual", 30))),
    "filter_sets": lambda E, b: (
        b.filter(_cond(E, "InSet", value_set=["NYC"], column="city"))
        .filter(_cond(E, "NotInSet", value_set=["SF", "LA"],
                      column="city"))),
    "filter_combinators": lambda E, b: (
        b.filter(E.BooleanAnd([E.NullWritableColumnCondition("age"),
                               E.StringRegexColumnCondition("name", "e.*")]))
        .filter(E.BooleanNot(_cond(E, "Equal", "SF", column="city")))
        .filter(E.BooleanOr([E.StringRegexColumnCondition("name", "b.b"),
                             E.InvalidValueColumnCondition("age")]))),
    "filter_invalid": lambda E, b: b.filter_invalid_values("age", "city"),
    "reduce": lambda E, b: (
        b.remove_columns("ts").reduce(E.Reducer(
            key_columns=["city"],
            ops={"age": "Mean", "score": "Stdev", "name": "TakeLast"}))),
    "reduce_default": lambda E, b: (
        b.remove_columns("ts", "name").duplicate_column("age", "a2")
        .duplicate_column("age", "a3").duplicate_column("age", "a4")
        .duplicate_column("age", "a5").duplicate_column("age", "a6")
        .duplicate_column("age", "a7").reduce(E.Reducer(
            key_columns=["city"],
            ops={"age": "Sum", "a2": "Min", "a3": "Max", "a4": "Range",
                 "a5": "Count", "a6": "CountUnique", "a7": "TakeFirst"},
            default_op="Mean"))),
    "sequence": lambda E, b: (
        b.replace_empty_with_value("age", 20)
        .replace_empty_with_value("score", 9.0)
        .convert_to_sequence("city", order_column="age", ascending=False)
        .transform(SIDES[E].SequenceDifferenceTransform("score"))
        .transform(SIDES[E].SequenceOffsetTransform(["age"], -1))
        .transform(SIDES[E].SequenceTrimTransform(0, from_first=False))
        .convert_from_sequence()),
    "sequence_trim": lambda E, b: (
        b.convert_to_sequence(["city"])
        .transform(SIDES[E].SequenceTrimTransform(1))),
}


def _process(E, name):
    return PROCESSES[name](E, E.TransformProcess.Builder(_schema(E))).build()


def _run(E, tp):
    return E.LocalTransformExecutor.execute(ROWS, tp)


@pytest.mark.parametrize("name", sorted(PROCESSES))
def test_process_records_and_json_match_and_cross_read(name):
    jtp, ttp = _process(J, name), _process(T, name)
    assert ttp.to_json() == jtp.to_json()
    assert ttp.final_schema().to_json() == jtp.final_schema().to_json()
    out = _run(T, ttp)
    assert out == _run(J, jtp)
    # each side reads the other's JSON into the same process
    from_j = T.TransformProcess.from_json(jtp.to_json())
    from_t = J.TransformProcess.from_json(ttp.to_json())
    assert from_j.to_json() == jtp.to_json() == from_t.to_json()
    assert _run(T, from_j) == out == _run(J, from_t)


@pytest.mark.parametrize("kind", ["schema", "sequence_schema", "inferred"])
def test_schema_json_matches_and_cross_reads(kind):
    def make(E):
        if kind == "schema":
            return _schema(E)
        if kind == "sequence_schema":
            return (E.SequenceSchema.Builder().add_column_double("x", 0, 1)
                    .add_column_long("n").add_column_float("f")
                    .add_column_time("t").add_column_boolean("b")
                    .add_column_ndarray("a").add_columns_double("d1", "d2")
                    .add_columns_integer("i1").add_columns_string("s1")
                    .build())
        return E.infer_schema([r[:4] for r in ROWS[:4]],
                              ["name", "city", "age", "score"])
    js, ts = make(J), make(T)
    assert ts.to_json() == js.to_json()
    assert T.Schema.from_json(js.to_json()) == ts
    assert J.Schema.from_json(ts.to_json()) == js
    assert type(T.Schema.from_json(js.to_json())).__name__ == \
        type(js).__name__
    assert ts.column_names() == js.column_names()
    assert [ts.column_type(c).value for c in ts.column_names()] == \
        [js.column_type(c).value for c in js.column_names()]


def test_analysis_and_quality_match():
    def run(E):
        a = E.analyze_local(_schema(E), ROWS)
        q = E.analyze_quality_local(_schema(E), ROWS)
        return ([dataclasses.asdict(c) for c in a.columns],
                [dataclasses.asdict(c) for c in q.columns],
                dataclasses.asdict(a.analysis_for("age")),
                dataclasses.asdict(q.quality_for("age")))
    assert run(T) == run(J)


@pytest.mark.parametrize("how", ["INNER", "LEFT_OUTER", "RIGHT_OUTER",
                                 "FULL_OUTER", "collision"])
def test_join_matches(how):
    def run(E):
        left = (E.Schema.Builder().add_column_integer("id")
                .add_column_string("name").add_column_double("v").build())
        right = (E.Schema.Builder().add_column_integer("id")
                 .add_column_double("v" if how == "collision" else "score")
                 .build())
        jt = getattr(E.JoinType, "INNER" if how == "collision" else how)
        join = (E.Join.builder(jt).set_join_columns("id")
                .set_schemas(left, right).build())
        out = join.execute([[1, "a", 0.1], [2, "b", 0.2], [3, "c", 0.3]],
                           [[2, 0.5], [3, 0.7], [4, 0.9]])
        return out, join.output_schema().to_json()
    assert run(T) == run(J)


# -- readers and writers -------------------------------------------------

def _write_inputs(root):
    (root / "data.csv").write_text("h1,h2,h3\n1,2.5,foo\n4,5.5,\"b,ar\"\n")
    (root / "seq").mkdir()
    for i, content in enumerate(["1,10\n2,20\n", "3,30\n"]):
        (root / "seq" / f"seq_{i}.csv").write_text(content)
    (root / "seq" / "skip.txt").write_text("9\n")


READERS = {
    "csv_string": lambda E, r: list(E.CSVRecordReader().initialize(
        E.StringSplit("1,2.5,foo\n4,5.5,bar\n"))),
    "csv_file": lambda E, r: list(E.CSVRecordReader(
        skip_num_lines=1).initialize(E.FileSplit(str(r / "data.csv")))),
    "csv_meta": lambda E, r: (lambda rr: [
        (rec, m.uri.endswith("data.csv"), m.position) for rec, m in
        (rr.next_with_meta(), rr.next_with_meta())])(
            E.CSVRecordReader(skip_num_lines=1, delimiter=",").initialize(
                E.FileSplit(str(r / "data.csv")))),
    "line": lambda E, r: list(E.LineRecordReader().initialize(
        E.StringSplit("a\nb\n\nc"))),
    "collection": lambda E, r: list(E.CollectionRecordReader(
        ROWS).initialize()),
    "jackson": lambda E, r: list(E.JacksonLineRecordReader(
        ["b", "a", "c"]).initialize(E.StringSplit(
            '{"a": 1, "b": "x"}\n{"a": 2, "b": "y", "c": 3.5}\n'))),
    "svmlight": lambda E, r: list(E.SVMLightRecordReader(
        num_features=4).initialize(E.StringSplit(
            "1 1:0.5 3:2.0\n0 2:1.5 # c\n"))),
    "svmlight_zero": lambda E, r: list(E.SVMLightRecordReader(
        num_features=3, zero_based=True).initialize(E.StringSplit(
            "2 0:1 2:3\n"))),
    "csv_sequence": lambda E, r: list(E.CSVSequenceRecordReader(
        ).initialize(E.FileSplit(str(r / "seq"),
                                 allowed_extensions=["csv"]))),
    "file_split": lambda E, r: [sorted(os.path.basename(p) for p in s.locations())
                                for s in (E.FileSplit(str(r / "seq")),
                                          E.FileSplit(str(r / "seq"), ["csv"],
                                                      rng_seed=1),
                                          E.CollectionInputSplit(["b", "a"]))],
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_matches(name, tmp_path):
    _write_inputs(tmp_path)
    got = READERS[name](T, tmp_path)
    assert got == READERS[name](J, tmp_path)
    assert got  # the case read something


@pytest.mark.parametrize("kind", ["csv", "excel"])
def test_writers_match_and_cross_read(kind, tmp_path):
    rows = [["name", "score", "flag"], ["a", 1.25, True],
            ["b <&> c", -3, False], ["n", float("nan"), 1.0]]
    paths = {}
    for E, tag in ((J, "j"), (T, "t")):
        p = str(tmp_path / f"{tag}.{'csv' if kind == 'csv' else 'xlsx'}")
        if kind == "csv":
            with E.CSVRecordWriter(p) as w:
                w.write_all(rows)
        else:
            w = E.ExcelRecordWriter(p, sheet_name='my "best" sheet')
            w.write_batch(rows[:2])
            w.write(rows[2])
            w.write_batch(rows[3:])
            w.close()
        paths[E] = p

    def read(E, p):
        rr = (E.CSVRecordReader if kind == "csv" else E.ExcelRecordReader)(
            **({"skip_num_lines": 1} if kind == "csv"
               else {"skip_num_rows": 1}))
        return list(rr.initialize(E.FileSplit(p)))
    if kind == "csv":
        assert open(paths[T]).read() == open(paths[J]).read()
    else:
        with zipfile.ZipFile(paths[T]) as zt, zipfile.ZipFile(paths[J]) as zj:
            assert zt.namelist() == zj.namelist()
            assert all(zt.read(n) == zj.read(n) for n in zt.namelist())
    expect = read(J, paths[J])
    assert read(T, paths[J]) == expect == read(J, paths[T]) == \
        read(T, paths[T])


def _foreign_xlsx(path, ordered):
    ns = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
    shared = (f'<sst xmlns="{ns}"><si><t>alpha</t><rPh sb="0" eb="2"><t>'
              'IGNORED</t></rPh></si><si><r><t>be</t></r><r><t>ta</t></r>'
              '</si><si><t>sheet2str</t></si></sst>')
    sheet1 = (f'<worksheet xmlns="{ns}"><sheetData>'
              '<row r="1"><c r="A1" t="s"><v>0</v></c>'
              '<c r="B1"><v>1.5</v></c><c r="C1" t="s"><v>1</v></c></row>'
              '<row r="2"><c r="A2"><v>7</v></c><c r="C2" t="inlineStr">'
              '<is><t>in</t></is></c></row></sheetData></worksheet>')
    sheet2 = (f'<worksheet xmlns="{ns}"><sheetData>'
              '<row r="1"><c r="A1" t="s"><v>2</v></c>'
              '<c r="B1"><v>42</v></c></row></sheetData></worksheet>')
    with zipfile.ZipFile(path, "w") as z:
        if ordered:
            z.writestr("xl/workbook.xml", (
                f'<workbook xmlns="{ns}" xmlns:r="http://schemas.'
                'openxmlformats.org/officeDocument/2006/relationships">'
                '<sheets><sheet name="B" sheetId="1" r:id="rId2"/>'
                '<sheet name="A" sheetId="2" r:id="rId1"/></sheets>'
                '</workbook>'))
            z.writestr("xl/_rels/workbook.xml.rels", (
                '<Relationships xmlns="http://schemas.openxmlformats.org/'
                'package/2006/relationships">'
                '<Relationship Id="rId1" Type="t" '
                'Target="worksheets/sheet1.xml"/>'
                '<Relationship Id="rId2" Type="t" '
                'Target="worksheets/sheet2.xml"/></Relationships>'))
        z.writestr("xl/sharedStrings.xml", shared)
        z.writestr("xl/worksheets/sheet1.xml", sheet1)
        z.writestr("xl/worksheets/sheet2.xml", sheet2)


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("skip", [0, 1])
def test_excel_reader_on_foreign_workbooks_matches(ordered, skip, tmp_path):
    p = str(tmp_path / "foreign.xlsx")
    _foreign_xlsx(p, ordered)

    def read(E):
        return list(E.ExcelRecordReader(skip_num_rows=skip).initialize(
            E.FileSplit(p)))
    assert read(T) == read(J)


def _coffee():
    conn = sqlite3.connect(":memory:")
    conn.execute("CREATE TABLE coffee (id INTEGER, name TEXT, "
                 "strength REAL)")
    conn.executemany("INSERT INTO coffee VALUES (?, ?, ?)",
                     [(1, " espresso ", 9.5), (2, "latte", 3.0),
                      (3, "filter", 5.5)])
    return conn


def test_jdbc_reader_matches():
    def run(E):
        out = []
        conn = _coffee()
        rr = E.JDBCRecordReader(
            "SELECT id, name, strength FROM coffee ORDER BY id",
            metadata_query="SELECT id, name, strength FROM coffee "
                           "WHERE id = ?", metadata_indices=[0])
        rr.initialize(conn)
        rec, meta = rr.next_with_meta()
        out += [rec, meta.values, rr.load_from_meta(meta), list(rr),
                rr.get_labels()]
        trim = E.JDBCRecordReader("SELECT name FROM coffee ORDER BY id",
                                  trim_strings=True)
        trim.initialize(conn)
        out.append(trim.next())
        count = E.JDBCRecordReader("SELECT count(*) FROM coffee")
        count.initialize(conn)
        out.append(count.next())
        conn.execute("INSERT INTO coffee VALUES (4, 'mocha', 6.0)")
        count.reset()
        out.append(count.next())       # reset rewinds the fetched rows
        count.refresh()
        out.append(count.next())       # refresh re-executes the query
        with pytest.raises(RuntimeError, match="initialize"):
            E.JDBCRecordReader("SELECT 1").refresh()
        return out
    assert run(T) == run(J)


def test_columnar_matches(tmp_path):
    if not J.columnar.available():
        pytest.skip("pyarrow not present")
    assert T.columnar.available()

    def run(E, tag):
        schema = (E.Schema.Builder().add_column_string("name")
                  .add_column_integer("count").add_column_double("score")
                  .build())
        records = [["a", 1, 0.5], ["b", 2, 1.5], ["c", 3, 2.5]]
        arrow = str(tmp_path / f"{tag}.arrow")
        parquet = str(tmp_path / f"{tag}.parquet")
        E.columnar.write_arrow(arrow, schema, records)
        E.columnar.write_parquet(parquet, schema, records)
        rr = E.columnar.ArrowRecordReader(arrow)
        got = [rr.schema.to_json(), [rr.next() for _ in iter(rr.has_next,
                                                             False)]]
        pq = E.columnar.ParquetRecordReader(parquet, columns=["count",
                                                              "score"])
        feats = E.columnar.to_features(list(pq))
        tp = (E.TransformProcess.Builder(rr.schema).remove_columns("name")
              .build())
        got += [list(E.columnar.ParquetRecordReader(parquet)), feats.tolist(),
                str(feats.dtype), E.ShardedTransformExecutor(0, 1).execute(
                    list(E.columnar.ParquetRecordReader(parquet)), tp)]
        return got
    assert run(T, "t") == run(J, "j")


# -- image transforms and the image reader -------------------------------

def _img(c=3, h=32, w=32, seed=0):
    return np.random.RandomState(seed).rand(c, h, w).astype(np.float32) * 255


IMAGE_TRANSFORMS = {
    "resize": lambda E: E.ResizeImageTransform(16, 24),
    "crop": lambda E: E.CropImageTransform(2, 3, 4, 5),
    "random_crop": lambda E: E.RandomCropTransform(16, 16),
    "random_crop_seeded": lambda E: E.RandomCropTransform(12, 20, seed=4),
    "flip_h": lambda E: E.FlipImageTransform(1),
    "flip_v": lambda E: E.FlipImageTransform(0),
    "flip_both": lambda E: E.FlipImageTransform(-1),
    "flip_random": lambda E: E.FlipImageTransform(None),
    "rotate": lambda E: E.RotateImageTransform(30.0, jitter=10.0),
    "scale": lambda E: E.ScaleImageTransform(0.5, jitter=0.1),
    "box_pad": lambda E: E.BoxImageTransform(40, 36),
    "box_crop": lambda E: E.BoxImageTransform(6, 10),
    "gray": lambda E: E.ColorConversionTransform("rgb2gray"),
    "gray_rgb": lambda E: E.MultiImageTransform(
        E.ColorConversionTransform("rgb2gray"),
        E.ColorConversionTransform("gray2rgb")),
    "normalize": lambda E: E.NormalizeImageTransform(
        255.0, mean=[0.5, 0.4, 0.3], std=[0.25, 0.2, 0.3]),
    "pipeline": lambda E: E.PipelineImageTransform(
        [(E.FlipImageTransform(1), 0.5), (E.ResizeImageTransform(8, 8), 1.0),
         (E.RotateImageTransform(90), 0.5)], shuffle=True, seed=3),
    "process": lambda E: (E.ImageTransformProcess.builder()
                          .resize_image_transform(24, 24)
                          .crop_image_transform(1, 1, 1, 1)
                          .random_crop_transform(20, 20)
                          .flip_image_transform(1)
                          .rotate_image_transform(15.0, 5.0)
                          .scale_image_transform(1.2, 0.9, 0.05)
                          .color_conversion_transform("rgb2gray")
                          .normalize_image_transform(255.0)
                          .build()),
}


@pytest.mark.parametrize("name", sorted(IMAGE_TRANSFORMS))
def test_image_transform_matches_for_the_same_random_state(name):
    def run(E):
        t = IMAGE_TRANSFORMS[name](E)
        img = _img()
        if isinstance(t, E.ImageTransformProcess):
            return t.execute(img, np.random.RandomState(7))
        return t.transform(img, np.random.RandomState(7))
    got, want = run(T), run(J)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_image_record_reader_matches(tmp_path):
    from PIL import Image
    rs = np.random.RandomState(0)
    for label in ("cat", "dog"):
        os.makedirs(tmp_path / label, exist_ok=True)
        for i in range(3):
            arr = (rs.rand(40, 40, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(tmp_path / label / f"{i}.png")

    def run(E):
        proc = (E.ImageTransformProcess.builder()
                .random_crop_transform(36, 36)
                .resize_image_transform(28, 28)
                .normalize_image_transform(255.0).build())
        rr = E.ImageRecordReader(40, 40, 3, E.ParentPathLabelGenerator(),
                                 image_transform=proc, seed=0)
        rr.initialize(E.FileSplit(str(tmp_path), [".png"]))
        out = [rr.next() for _ in iter(rr.has_next, False)]
        rr.reset()
        img, meta = rr.next_with_meta()
        return out, rr.get_labels(), img, meta.uri
    (t_out, t_labels, t_img, t_uri), (j_out, j_labels, j_img, j_uri) = \
        run(T), run(J)
    assert t_labels == j_labels and t_uri == j_uri
    assert [lab for _, lab in t_out] == [lab for _, lab in j_out]
    for (a, _), (b, _) in zip(t_out, j_out):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_img[0], j_img[0])


# -- sharded execution ------------------------------------------------------

def test_sharded_executor_matches():
    def run(E):
        schema = (E.Schema.Builder().add_column_integer("x")
                  .add_column_integer("y").build())
        records = [[i, i * 10] for i in range(11)]
        tp = E.TransformProcess.Builder(schema).remove_columns("y").build()
        files = [f"f{i:02d}.csv" for i in range(7)]
        return ([E.shard_records(records, i, 4) for i in range(4)],
                E.shard_files(list(reversed(files)), 1, 3),
                E.ShardedTransformExecutor(process_count=3,
                                           process_index=0).execute_all(
                                               records, tp),
                E.ShardedTransformExecutor(2, 3).execute(records, tp))
    assert run(T) == run(J)


def test_process_info_without_a_process_group_is_one_process():
    import torch.distributed as dist
    assert not (dist.is_available() and dist.is_initialized())
    assert tdist._process_info(None, None) == (0, 1)
    assert tdist._process_info(2, 5) == (2, 5)
    ex = T.ShardedTransformExecutor()
    assert (ex.process_index, ex.process_count) == (0, 1)
    assert T.shard_records([1, 2, 3]) == [1, 2, 3]


def test_etl_exports_the_jax_package_names():
    assert sorted(T.__all__) == sorted(J.__all__)
    assert json.loads(_process(T, "columns").to_json())["steps"][0][
        "@class"] == "RemoveColumnsTransform"
