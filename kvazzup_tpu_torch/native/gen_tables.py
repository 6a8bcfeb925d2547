"""Generate cabac_tables.h from the Python table module (single source)."""

from __future__ import annotations

import os


def generate(path: str) -> None:
    from ..entropy import cabac_tables as t

    lines = ["/* generated by gen_tables.py — do not edit */", "#pragma once", "#include <stdint.h>", ""]
    lps = t.RANGE_TAB_LPS
    lines.append("static const uint8_t RANGE_TAB_LPS[64][4] = {")
    for row in lps:
        lines.append("  {" + ",".join(str(int(x)) for x in row) + "},")
    lines.append("};")
    for name, arr in (("TRANS_IDX_LPS", t.TRANS_IDX_LPS), ("TRANS_IDX_MPS", t.TRANS_IDX_MPS)):
        lines.append(f"static const uint8_t {name}[64] = {{" + ",".join(str(int(x)) for x in arr) + "};")
    lines.append(f"#define NUM_CONTEXTS {t.NUM_CONTEXTS}")
    for name, off in t.OFFSETS.items():
        lines.append(f"#define CTX_{name.upper()} {off}")
    # init values flattened per init type
    for it in range(3):
        vals = []
        for name, tabs in t.INIT_VALUES.items():
            vals.extend(tabs[it])
        lines.append(
            f"static const uint8_t INIT_VALUES_{it}[NUM_CONTEXTS] = {{"
            + ",".join(str(v) for v in vals)
            + "};"
        )
    # ---- reconstruction tables (decode-side recon in C: intra predict,
    # dequant, inverse transform, MC interpolation, chroma QP) ----
    from ..core import tables as ct
    from ..ops.mc import CHROMA_FILTERS, LUMA_FILTERS  # the port's own tables

    def mat(name, a, ctype="int16_t"):
        a = [list(map(int, row)) for row in a]
        rows = ",".join("{" + ",".join(str(v) for v in r) + "}" for r in a)
        lines.append(
            f"static const {ctype} {name}[{len(a)}][{len(a[0])}] = {{{rows}}};")

    for n in (4, 8, 16, 32):
        mat(f"DCT{n}", ct.dct_matrix(n))
    mat("DST4", ct.DST4)
    mat("LUMA_FILTERS", LUMA_FILTERS, "int8_t")
    mat("CHROMA_FILTERS", CHROMA_FILTERS, "int8_t")
    lines.append("static const uint8_t CHROMA_QP_TABLE[58] = {"
                 + ",".join(str(int(v)) for v in ct.CHROMA_QP_TABLE) + "};")
    lines.append("static const int8_t DEQUANT_SCALES[6] = {"
                 + ",".join(str(int(v)) for v in ct.DEQUANT_SCALES) + "};")
    lines.append("static const int8_t INTRA_PRED_ANGLE[33] = {"
                 + ",".join(str(int(v)) for v in ct.INTRA_PRED_ANGLE) + "};")
    lines.append("static const int16_t INTRA_INV_ANGLE[15] = {"
                 + ",".join(str(int(v)) for v in ct.INTRA_INV_ANGLE) + "};")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
    generate(os.path.join(os.path.dirname(__file__), "..", "build", "cabac_tables.h"))
