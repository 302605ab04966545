"""Excel (.xlsx) record reader/writer.

Reference: `datavec/datavec-excel/src/main/java/org/datavec/poi/excel/
ExcelRecordReader.java` / `ExcelRecordWriter.java` (Apache-POI-based).
No POI here and no third-party wheel in the image: .xlsx is a zip of
SpreadsheetML XML, read with stdlib ``zipfile`` + ``xml.etree`` — shared
strings, inline strings, and numeric cells; all sheets of every workbook
in the split, rows as lists (the FileRecordReader contract).
"""
from __future__ import annotations

import re
import zipfile
from typing import List, Optional
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

from .records import RecordMetaData, _ListBackedReader

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"


def _finite(v) -> bool:
    """NaN/inf are not valid SpreadsheetML numeric cells — such values
    fall through to the inline-string branch."""
    return v == v and v not in (float("inf"), float("-inf"))


def _col_index(cell_ref: str) -> int:
    """'C7' -> 2 (zero-based column from the A1-style reference)."""
    col = 0
    for ch in cell_ref:
        if ch.isalpha():
            col = col * 26 + (ord(ch.upper()) - ord("A") + 1)
        else:
            break
    return col - 1


def _shared_strings(zf: zipfile.ZipFile) -> List[str]:
    try:
        data = zf.read("xl/sharedStrings.xml")
    except KeyError:
        return []
    root = ET.fromstring(data)
    out = []
    for si in root.findall(f"{_NS}si"):
        # direct <t> plus rich-text <r>/<t> runs; phonetic <rPh> runs are
        # annotations (furigana), NOT part of the cell text
        parts = [t.text or "" for t in si.findall(f"{_NS}t")]
        for r in si.findall(f"{_NS}r"):
            parts.extend(t.text or "" for t in r.findall(f"{_NS}t"))
        out.append("".join(parts))
    return out


_REL_NS = "{http://schemas.openxmlformats.org/package/2006/relationships}"
_DOCREL = ("{http://schemas.openxmlformats.org/officeDocument/2006/"
           "relationships}")


def _sheet_names(zf: zipfile.ZipFile) -> List[str]:
    """Worksheet part names in WORKBOOK order (xl/workbook.xml <sheets>
    resolved through the relationships part — users reorder sheets
    without renaming the parts); falls back to part-number order for
    minimal workbooks without workbook.xml."""
    try:
        wb = ET.fromstring(zf.read("xl/workbook.xml"))
        rels = ET.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
        target_by_id = {rel.get("Id"): rel.get("Target")
                        for rel in rels.findall(f"{_REL_NS}Relationship")}
        ordered = []
        sheets = wb.find(f"{_NS}sheets")
        for sheet in (sheets if sheets is not None else []):
            target = target_by_id.get(sheet.get(f"{_DOCREL}id"))
            if target:
                t = target.lstrip("/")
                ordered.append(t if t.startswith("xl/") else f"xl/{t}")
        if ordered:
            return ordered
    except (KeyError, ET.ParseError):
        pass
    names = [n for n in zf.namelist()
             if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n)]
    return sorted(names, key=lambda n: int(re.search(r"\d+", n).group()))


def _parse_sheet(data: bytes, shared: List[str]) -> List[List]:
    rows = []
    root = ET.fromstring(data)
    for row in root.iter(f"{_NS}row"):
        values: List = []
        for c in row.findall(f"{_NS}c"):
            ref = c.get("r")
            idx = _col_index(ref) if ref else len(values)
            while len(values) < idx:
                values.append("")       # gap cells read as empty
            t = c.get("t", "n")
            if t == "s":
                v = c.find(f"{_NS}v")
                values.append(shared[int(v.text)] if v is not None else "")
            elif t == "inlineStr":
                is_el = c.find(f"{_NS}is")
                values.append("".join(tt.text or "" for tt in
                                      is_el.iter(f"{_NS}t"))
                              if is_el is not None else "")
            else:                        # n / str / b
                v = c.find(f"{_NS}v")
                values.append(v.text if v is not None and v.text is not None
                              else "")
        rows.append(values)
    return rows


class ExcelRecordReader(_ListBackedReader):
    """Rows of every sheet of every .xlsx in the split, values as strings
    (typing happens via Schema/TransformProcess, like CSVRecordReader).

    skip_num_rows skips leading rows PER SHEET (header rows), matching the
    reference's per-sheet row iteration."""

    def __init__(self, skip_num_rows: int = 0):
        super().__init__()
        self.skip_num_rows = skip_num_rows

    def initialize(self, split):
        self._records, self._metas = [], []
        for path in split.locations():
            with zipfile.ZipFile(path) as zf:
                shared = _shared_strings(zf)
                for sheet in _sheet_names(zf):
                    rows = _parse_sheet(zf.read(sheet), shared)
                    for i, row in enumerate(rows):
                        if i < self.skip_num_rows or not row:
                            continue
                        self._records.append(row)
                        self._metas.append(
                            RecordMetaData(f"{path}#{sheet}", i))
        self.reset()
        return self


class ExcelRecordWriter:
    """Write records to a single-sheet .xlsx (reference ExcelRecordWriter;
    numbers as numeric cells, everything else as inline strings — openable
    by Excel and by :class:`ExcelRecordReader`)."""

    def __init__(self, path: str, sheet_name: str = "Sheet1"):
        self.path = path
        self.sheet_name = sheet_name
        self._rows: List[List] = []

    def write(self, record: List) -> None:
        self._rows.append(list(record))

    def write_batch(self, records) -> None:
        for r in records:
            self.write(r)

    def close(self) -> None:
        cells = []
        for ri, row in enumerate(self._rows, start=1):
            cs = []
            for ci, val in enumerate(row):
                ref = f"{_col_letter(ci)}{ri}"
                if isinstance(val, bool):
                    cs.append(f'<c r="{ref}" t="b"><v>{int(val)}</v></c>')
                elif isinstance(val, (int, float)) and _finite(val):
                    cs.append(f'<c r="{ref}"><v>{val}</v></c>')
                else:
                    cs.append(f'<c r="{ref}" t="inlineStr"><is><t>'
                              f"{escape(str(val))}</t></is></c>")
            cells.append(f'<row r="{ri}">{"".join(cs)}</row>')
        sheet = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                 '<worksheet xmlns="http://schemas.openxmlformats.org/'
                 'spreadsheetml/2006/main"><sheetData>'
                 + "".join(cells) + "</sheetData></worksheet>")
        ct = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
              '<Types xmlns="http://schemas.openxmlformats.org/package/'
              '2006/content-types">'
              '<Default Extension="rels" ContentType="application/vnd.'
              'openxmlformats-package.relationships+xml"/>'
              '<Default Extension="xml" ContentType="application/xml"/>'
              '<Override PartName="/xl/workbook.xml" ContentType='
              '"application/vnd.openxmlformats-officedocument.'
              'spreadsheetml.sheet.main+xml"/>'
              '<Override PartName="/xl/worksheets/sheet1.xml" ContentType='
              '"application/vnd.openxmlformats-officedocument.'
              'spreadsheetml.worksheet+xml"/></Types>')
        rels = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                '<Relationships xmlns="http://schemas.openxmlformats.org/'
                'package/2006/relationships">'
                '<Relationship Id="rId1" Type="http://schemas.'
                'openxmlformats.org/officeDocument/2006/relationships/'
                'officeDocument" Target="xl/workbook.xml"/></Relationships>')
        wb = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
              '<workbook xmlns="http://schemas.openxmlformats.org/'
              'spreadsheetml/2006/main" xmlns:r="http://schemas.'
              'openxmlformats.org/officeDocument/2006/relationships">'
              '<sheets><sheet name="'
              + escape(self.sheet_name, {'"': "&quot;"})
              + '" sheetId="1" r:id="rId1"/></sheets></workbook>')
        wb_rels = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                   '<Relationships xmlns="http://schemas.openxmlformats.'
                   'org/package/2006/relationships">'
                   '<Relationship Id="rId1" Type="http://schemas.'
                   'openxmlformats.org/officeDocument/2006/relationships/'
                   'worksheet" Target="worksheets/sheet1.xml"/>'
                   '</Relationships>')
        with zipfile.ZipFile(self.path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("[Content_Types].xml", ct)
            z.writestr("_rels/.rels", rels)
            z.writestr("xl/workbook.xml", wb)
            z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
            z.writestr("xl/worksheets/sheet1.xml", sheet)


def _col_letter(idx: int) -> str:
    out = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        out = chr(ord("A") + rem) + out
    return out
