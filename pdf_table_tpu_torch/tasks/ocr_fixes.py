"""OCR text post-fix heuristics (copy of pdf_table_tpu/tasks/ocr_fixes.py):
small text-level rules applied after recognition: lone O/o misreads of
digit zero, thousands separators misread as dots inside numbers, and the
180-degree page check that compares the non-CJK character ratio of the
normal vs rotated OCR pass.
"""

from __future__ import annotations

import re
from typing import List, Sequence

_PATTERN_OCR_ZERO = re.compile(r"^[OoQq]$")
_NUMBERISH = re.compile(r"^[0-9.,%\-+]+$")
_NONE_ZH = re.compile(r"[^一-龥]")


def ocr_post_process(text: str) -> str:
    """Per-cell OCR text fix (ocr_post_process:1328): a lone 'O'/'o' is a
    digit zero; a number with several dots keeps only the last as the
    decimal point (earlier ones were comma separators)."""
    new_text = text
    clean = text.replace(" ", "")
    if len(clean) == 1 and _PATTERN_OCR_ZERO.match(clean):
        new_text = "0"
    if clean and _NUMBERISH.match(clean):
        if text.count(".") > 1:
            last = text.rfind(".")
            new_text = text[:last].replace(".", ",") + text[last:]
    return new_text


def check_pdf_text_need_rotate(texts: Sequence[str],
                               texts_rotated: Sequence[str]) -> bool:
    """True when the 180-degree-rotated OCR pass reads as MORE Chinese
    (lower non-CJK ratio) than the normal pass — the page was upside down
    (check_pdf_text_need_rotate:1531)."""
    content = "".join(texts).replace(" ", "")
    content2 = "".join(texts_rotated).replace(" ", "")
    if not content or not content2:
        return False
    r1 = len("".join(_NONE_ZH.findall(content))) / len(content)
    r2 = len("".join(_NONE_ZH.findall(content2))) / len(content2)
    return r2 < r1


def apply_ocr_post_process(texts: List[str]) -> List[str]:
    return [ocr_post_process(t) for t in texts]
