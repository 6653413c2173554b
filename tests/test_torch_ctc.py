"""The port's CTC greedy decode against the JAX package's on the same
logits: ids and keep masks equal, confidences within 1e-6 (a mean of f32
softmax maxima, summed in another order). ``argmax`` ties: both sides take
the first maximum, which the tie cases below hold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdf_table_tpu.models.rec_ctc.charset import \
    default_en_charset as j_default_en_charset
from pdf_table_tpu.models.rec_ctc.charset import \
    generic_lang_charset as j_generic_lang_charset
from pdf_table_tpu.ops.ctc import ctc_greedy_decode as j_decode
from pdf_table_tpu.ops.ctc import ids_to_text as j_ids_to_text
from pdf_table_tpu_torch.models.rec_ctc.charset import (Charset,
                                                        default_en_charset,
                                                        generic_lang_charset,
                                                        resolve_charset)
from pdf_table_tpu_torch.ops.ctc import ctc_greedy_decode, ids_to_text

torch.set_num_threads(1)


def _onehot(rows, vocab, scale=8.0):
    """Logits whose argmax per step is given; ``rows`` is (B, T) ids."""
    rows = np.asarray(rows)
    out = np.zeros((*rows.shape, vocab), np.float32)
    np.put_along_axis(out, rows[..., None], scale, axis=-1)
    return out


def _cases():
    rng = np.random.default_rng(0)
    yield "random", rng.standard_normal((5, 40, 97)).astype(np.float32), 0
    yield "all_blank", _onehot([[0] * 6], 10), 0
    yield "repeats", _onehot([[3, 3, 3, 0, 3, 4, 4, 0, 0, 5]], 10), 0
    yield "leading_repeat", _onehot([[7, 7, 1, 1]], 10), 0
    yield "other_blank", _onehot([[2, 2, 9, 9, 1, 9]], 10), 9
    ties = np.zeros((2, 5, 6), np.float32)      # every class ties: id 0
    ties[1, :, 2] = ties[1, :, 4] = 1.0         # classes 2 and 4 tie: id 2
    yield "ties", ties, 0
    yield "one_step", rng.standard_normal((3, 1, 12)).astype(np.float32), 0


@pytest.mark.parametrize("name,logits,blank",
                         [pytest.param(*c, id=c[0]) for c in _cases()])
def test_decode_matches_jax(name, logits, blank):
    w_ids, w_keep, w_conf = (np.asarray(a) for a in j_decode(
        jnp.asarray(logits), blank_id=blank))
    ids, keep, conf = ctc_greedy_decode(torch.from_numpy(logits),
                                        blank_id=blank)
    np.testing.assert_array_equal(ids.numpy(), w_ids)
    np.testing.assert_array_equal(keep.numpy(), w_keep)
    assert keep.dtype == torch.bool
    np.testing.assert_allclose(conf.numpy(), w_conf, rtol=0, atol=1e-6)


def test_edge_cases_by_hand():
    ids, keep, conf = ctc_greedy_decode(torch.from_numpy(
        _onehot([[3, 3, 0, 3, 4, 4], [0, 0, 0, 0, 0, 0]], 6)))
    assert ids.tolist() == [[3, 3, 0, 3, 4, 4], [0] * 6]
    assert keep.tolist() == [[True, False, False, True, True, False],
                             [False] * 6]
    assert float(conf[1]) == 0.0 and 0.9 < float(conf[0]) <= 1.0
    ties = torch.zeros((1, 3, 5))
    ties[0, :, 1] = ties[0, :, 3] = 2.0
    ids, keep, _ = ctc_greedy_decode(ties)
    assert ids.tolist() == [[1, 1, 1]]          # the first maximum
    assert keep.tolist() == [[True, False, False]]


def test_ids_to_text_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 30, 97)).astype(np.float32)
    ids, keep, _ = ctc_greedy_decode(torch.from_numpy(logits))
    cs = default_en_charset()
    jcs = j_default_en_charset()
    assert cs.id_to_char == jcs.id_to_char
    want = j_ids_to_text(ids.numpy(), keep.numpy(), jcs.id_to_char)
    got = ids_to_text(ids.numpy(), keep.numpy(), cs.id_to_char)
    assert got == want
    assert got == [cs.decode_ids(i[k].tolist())
                   for i, k in zip(ids.numpy(), keep.numpy())]


@pytest.mark.parametrize("lang", ["ch", "japan", "korean", "latin",
                                  "cyrillic"])
def test_generic_charsets_match_jax(lang):
    a, b = generic_lang_charset(lang), j_generic_lang_charset(lang)
    assert a.id_to_char == b.id_to_char
    assert a.generic_fallback and a.encode("a1 ") == b.encode("a1 ")


def test_resolve_charset(tmp_path, monkeypatch):
    assert len(resolve_charset("en")) == 96
    path = tmp_path / "dict.txt"
    path.write_text("a\nb\n\nc\n", encoding="utf-8")
    cs = resolve_charset(str(path))
    assert cs.id_to_char == ["<blank>", "a", "b", "c", " "]
    assert cs.decode_ids([1, 0, 3, 99, 4]) == "ac "
    # a lang key finds its dict file in $PDFTABLE_DICT_DIR
    (tmp_path / "korean_dict.txt").write_text("x\ny\n", encoding="utf-8")
    monkeypatch.setenv("PDFTABLE_DICT_DIR", str(tmp_path))
    assert resolve_charset("korean", use_space_char=False).id_to_char == \
        ["<blank>", "x", "y"]
    # without the file: the provisional charset, or an error when strict
    assert getattr(resolve_charset("japan"), "generic_fallback", False)
    with pytest.raises(ValueError, match="japan_dict.txt"):
        resolve_charset("japan", strict=True)
    with pytest.raises(ValueError, match="unknown charset"):
        resolve_charset("klingon")
    assert isinstance(cs, Charset)
