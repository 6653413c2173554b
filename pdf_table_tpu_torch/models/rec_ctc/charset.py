"""Character sets for CTC decode (copy of
pdf_table_tpu/models/rec_ctc/charset.py).

The charset is an explicit object: the built-in English printable set, or
one loaded from a dict file (one character a line, as PaddleOCR ships
them), with the CTC blank always at id 0. The dict files of the other
languages are not in the repository; a lang key without its file falls
back to a provisional codepoint-ordered charset unless ``strict``.
"""

from __future__ import annotations

import logging
import os
import string
from typing import List, Sequence

logger = logging.getLogger(__name__)


class Charset:
    def __init__(self, chars: Sequence[str], use_space_char: bool = True):
        chars = list(chars)
        if use_space_char and " " not in chars:
            chars.append(" ")
        # id 0 = CTC blank
        self.id_to_char: List[str] = ["<blank>"] + chars
        self.char_to_id = {c: i for i, c in enumerate(self.id_to_char)}

    def __len__(self) -> int:
        return len(self.id_to_char)

    def decode_ids(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            if 0 < i < len(self.id_to_char):
                out.append(self.id_to_char[i])
        return "".join(out)

    def encode(self, text: str) -> List[int]:
        return [self.char_to_id[c] for c in text if c in self.char_to_id]

    @classmethod
    def from_dict_file(cls, path: str, use_space_char: bool = True) -> "Charset":
        with open(path, encoding="utf-8") as f:
            chars = [line.rstrip("\n\r") for line in f if line.rstrip("\n\r")]
        return cls(chars, use_space_char)


def default_en_charset(use_space_char: bool = True) -> Charset:
    """94 printable ASCII (no space; space handled by flag) — matches the
    PP-OCR en_dict ordering convention: digits, letters, punctuation."""
    chars = list(string.digits) + list(string.ascii_letters) + \
        list("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
    return Charset(chars, use_space_char)


# lang -> dict filename convention (the files PaddleOCR ships beside its
# lang-keyed checkpoints)
LANG_DICT_FILES = {
    "ch": "ppocr_keys_v1.txt",
    "japan": "japan_dict.txt",
    "korean": "korean_dict.txt",
    "chinese_cht": "chinese_cht_dict.txt",
    "latin": "latin_dict.txt",
    "arabic": "arabic_dict.txt",
    "cyrillic": "cyrillic_dict.txt",
    "devanagari": "devanagari_dict.txt",
    "ta": "ta_dict.txt",
    "te": "te_dict.txt",
    "ka": "ka_dict.txt",
}


def dict_search_dirs(extra_dirs: Sequence[str] = ()) -> List[str]:
    """Dict file lookup order: ``extra_dirs`` first (a converted-weights
    dir holds the checkpoint's dict beside the weights), then
    $PDFTABLE_DICT_DIR, then the shared model cache's ``dicts`` dir
    ($PDFTABLE_MODEL_CACHE_DIR, default ~/.pdf_table_tpu/models)."""
    dirs = [d for d in extra_dirs if d]
    env = os.environ.get("PDFTABLE_DICT_DIR", "")
    if env:
        dirs.append(env)
    base = os.environ.get("PDFTABLE_BASE_DIR", os.path.join(
        os.path.expanduser("~"), ".pdf_table_tpu"))
    cache = os.environ.get("PDFTABLE_MODEL_CACHE_DIR",
                           os.path.join(base, "models"))
    dirs.append(os.path.join(cache, "dicts"))
    return dirs


# Unicode block ranges (inclusive start, exclusive end) backing the
# provisional per-lang charsets. Codepoint order, deterministic — NOT the
# PaddleOCR dict id order, so these never pair with converted checkpoints
# (resolve_charset enforces strict=True there).
_LANG_BLOCKS = {
    "ch": ((0x4E00, 0x9FA6),),
    "chinese_cht": ((0x4E00, 0x9FA6),),
    "japan": ((0x3041, 0x3097), (0x30A1, 0x30FB), (0x30FC, 0x30FD),
              (0x4E00, 0x9FA6)),
    "korean": ((0xAC00, 0xD7A4),),
    "latin": ((0x00C0, 0x00D7), (0x00D8, 0x00F7), (0x00F8, 0x0180),),
    "cyrillic": ((0x0400, 0x0500),),
    "arabic": ((0x0600, 0x0700), (0x0750, 0x0780)),
    "devanagari": ((0x0900, 0x0980),),
    "ta": ((0x0B80, 0x0C00),),
    "te": ((0x0C00, 0x0C80),),
    "ka": ((0x0C80, 0x0D00),),
}

_CJK_PUNCT = ("，。、；：？！“”"
              "‘’（）《》【】"
              "—…·￥")


def generic_lang_charset(lang: str, use_space_char: bool = True) -> Charset:
    """Provisional codepoint-ordered charset for ``lang``: ASCII printables
    + the language's Unicode block(s) (+ CJK punctuation for CJK langs).
    Deterministic and documented, so offline/structural runs and
    training-from-scratch work out of the box — but the ids do NOT match
    any PaddleOCR dict ordering, so converted checkpoints must use the
    real dict sidecar (resolve_charset refuses these in strict mode)."""
    if lang not in _LANG_BLOCKS:
        raise ValueError(f"no provisional charset for lang {lang!r}")
    chars = list(string.digits) + list(string.ascii_letters) + \
        list("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
    for lo, hi in _LANG_BLOCKS[lang]:
        chars += [chr(c) for c in range(lo, hi)]
    if lang in ("ch", "chinese_cht", "japan"):
        chars += list(_CJK_PUNCT)
    cs = Charset(chars, use_space_char)
    cs.generic_fallback = True
    return cs


def generic_cjk_charset(use_space_char: bool = True) -> Charset:
    """Back-compat alias: the provisional Chinese charset."""
    return generic_lang_charset("ch", use_space_char)


def resolve_charset(name_or_path: str, use_space_char: bool = True,
                    extra_dirs: Sequence[str] = (),
                    strict: bool = False) -> Charset:
    """Resolve a charset by lang key, dict-file path, or 'en' builtin.

    ``extra_dirs``: searched first for the lang's dict file — pass the
    converted-weights dir so the snapshot's dict is found automatically.
    ``strict``: raise instead of degrading to the generic CJK charset
    (required when decoding converted checkpoints: generic ids do not
    match PaddleOCR's ppocr_keys_v1 ordering).
    """
    if name_or_path == "en" or not name_or_path:
        return default_en_charset(use_space_char)
    if os.path.exists(name_or_path):
        return Charset.from_dict_file(name_or_path, use_space_char)
    if name_or_path in LANG_DICT_FILES:
        fname = LANG_DICT_FILES[name_or_path]
        dirs = dict_search_dirs(extra_dirs)
        for d in dirs:
            p = os.path.join(d, fname)
            if os.path.exists(p):
                return Charset.from_dict_file(p, use_space_char)
        if name_or_path in _LANG_BLOCKS and not strict:
            logger.warning(
                "no %s found under %s — using the provisional "
                "codepoint-ordered %s charset (ids do NOT match converted "
                "PaddleOCR checkpoints; place the real dict in one of those "
                "directories)",
                fname, dirs, name_or_path)
            return generic_lang_charset(name_or_path, use_space_char)
        raise ValueError(
            f"charset {name_or_path!r} needs its dict file {fname!r} in one "
            f"of {dirs}")
    raise ValueError(f"unknown charset {name_or_path!r}")
