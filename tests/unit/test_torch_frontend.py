"""The port's copy of the built-in text front end against the JAX
package's: text normalisation, letter-to-sound, the lexicon with its
morphological lookup, syllabification, the three accents, the
full-context labels and ``write_labels``.  Standard-library code: the
strings and files must be identical.

The texts are those of ``tests/unit/test_frontend.py`` and
``tests/integration/test_tts_model.py``.
"""

import os

import pytest

from idiaptts_tpu.synth import frontend as jax_frontend
from idiaptts_torch.synth import frontend as torch_frontend

TEXTS = (
    # tests/unit/test_frontend.py
    "Hello, World! It costs 42 dollars.",
    "the quick brown fox jumps over the lazy dog",
    "one. two",
    "hello world. again",
    "Dr. Smith lives on St. James",
    "It costs $5.50 today",
    "50% of the 3rd and the 22nd in 1984, 1901, 1900 and by 2025",
    "pi is 3.14 and 1,234 items",
    "She said no.",
    "car park red very bath dance cat water",
    "The bath near the car.",
    # tests/integration/test_tts_model.py
    "Hello world.",
    "Tests 42",
    "hello world this is online serving",
    "another request at the same time",
    "speech synthesis with no external front end",
    "a stitch in time saves nine",
    "pack my box with five dozen jugs",
    "how vexingly quick daft zebras jump",
    "numbers like 42 are spelled out",
    "hello world",
    "testing speech",
    # unknown words go through letter-to-sound
    "Zorbix quandled the flemptious glorbs, unthinkingly.",
)
ACCENTS = ("en-US", "en-GB", "unilex-rpx")
WORDS = ("ship", "thing", "quick", "lake", "ball", "bal", "bath", "pass",
         "passed", "classes", "dancing", "afternoon", "hand", "romantic",
         "passenger", "maths", "hers", "landowner", "prefer", "walked",
         "unhappiness", "rebuilding", "zorbix", "queueing", "psychology")


@pytest.fixture(scope="module")
def front_ends():
    return {accent: (jax_frontend.BuiltinFrontEnd(accent=accent),
                     torch_frontend.BuiltinFrontEnd(accent=accent))
            for accent in ACCENTS}


def test_default_lexicon_is_the_jax_package_asset():
    """The port reads its own copy, byte for byte the JAX asset."""
    assert os.path.isfile(torch_frontend.DEFAULT_LEXICON)
    assert not os.path.samefile(torch_frontend.DEFAULT_LEXICON,
                                jax_frontend.DEFAULT_LEXICON)
    assert os.path.dirname(torch_frontend.DEFAULT_LEXICON) == os.path.join(
        os.path.dirname(os.path.dirname(torch_frontend.__file__)), "assets")
    with open(torch_frontend.DEFAULT_LEXICON, "rb") as got, \
            open(jax_frontend.DEFAULT_LEXICON, "rb") as ref:
        assert got.read() == ref.read()


@pytest.mark.parametrize("accent", ACCENTS)
@pytest.mark.parametrize("text", TEXTS)
def test_full_labels_match_jax(front_ends, accent, text):
    ref_fe, fe = front_ends[accent]
    assert fe.lexicon == ref_fe.lexicon
    assert fe.text_to_phones(text) == ref_fe.text_to_phones(text)
    assert fe.text_to_full_labels(text) == ref_fe.text_to_full_labels(text)


@pytest.mark.parametrize("text", TEXTS)
def test_normalise_text_matches_jax(text):
    assert torch_frontend.normalise_text(text) \
        == jax_frontend.normalise_text(text)


def test_word_level_helpers_match_jax(front_ends):
    """letter_to_sound, the morphological lookup, syllabification and
    the two accent maps over the words of the JAX tests."""
    lexicon = front_ends["en-US"][1].lexicon
    for word in WORDS:
        assert torch_frontend.letter_to_sound(word) \
            == jax_frontend.letter_to_sound(word), word
        got = torch_frontend.morphological_lookup(word, lexicon)
        assert got == jax_frontend.morphological_lookup(word, lexicon), word
        entry = got or [(p, None) for p in
                        torch_frontend.letter_to_sound(word)]
        assert torch_frontend.syllabify(entry) \
            == jax_frontend.syllabify(entry), word
        for fn in ("to_received_pronunciation", "to_unilex_rpx"):
            assert getattr(torch_frontend, fn)(entry, word=word) \
                == getattr(jax_frontend, fn)(entry, word=word), (fn, word)


def test_lexicon_file_and_pure_rules_match_jax(tmp_path):
    lex_file = tmp_path / "lex.dict"
    lex_file.write_text("HELLO  HH AH0 L OW1\nHELLO(2)  HH EH0 L OW1\n"
                        "WORLD  W ER1 L D\n")
    for path in (str(lex_file), ""):
        ref = jax_frontend.BuiltinFrontEnd(lexicon_path=path)
        got = torch_frontend.BuiltinFrontEnd(lexicon_path=path)
        for text in ("hello world", "Hello, strange world."):
            assert got.text_to_full_labels(text) \
                == ref.text_to_full_labels(text)
    assert torch_frontend.load_lexicon(str(lex_file)) \
        == jax_frontend.load_lexicon(str(lex_file))


@pytest.mark.parametrize("accent", ACCENTS)
def test_write_labels_matches_jax(front_ends, accent, tmp_path):
    """write_labels: the same ids and byte-identical label files."""
    ref_fe, fe = front_ends[accent]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    ids_j = ref_fe.write_labels(list(TEXTS[:8]), out_j)
    ids_t = fe.write_labels(list(TEXTS[:8]), out_t)
    assert ids_t == ids_j
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    for name in os.listdir(out_j):
        with open(os.path.join(out_j, name), "rb") as a, \
                open(os.path.join(out_t, name), "rb") as b:
            assert a.read() == b.read(), name


def test_unknown_accent_is_refused():
    with pytest.raises(ValueError, match="accent"):
        torch_frontend.BuiltinFrontEnd(accent="fr-FR")
