"""Built-in text front end: text -> HTS full-context labels with no
external tools.  The port's copy of ``idiaptts_tpu/synth/frontend.py``
(standard library only).

Text normalisation, lexicon lookup (optional CMU-format dictionary,
stress digits kept) with a rule-based English letter-to-sound fallback
(ARPABET), syllabification with stress, phrase segmentation at major
punctuation, and label emission in the framework's HTS-shaped label
format, the format the committed question set
(``idiaptts_torch/assets/questions-en-arpabet_dnn.hed``, generated by
``tools/make_question_file.py``) is written for; see
``BuiltinFrontEnd.text_to_full_labels`` for the field layout (quinphone
+ /A/../J/ blocks covering the numeric-context dimensions of the
reference's questions-en-radio_dnn_416.hed CQS set).

``TTSModel.run_DM_AM`` uses this front end when no external
``front_end_cmd`` is configured.  The bundled lexicon is the port's own
copy, ``idiaptts_torch/assets/lexicon-en-us.dict`` (``DEFAULT_LEXICON``).
"""

import os
import re

# ARPABET phone classes (shared convention with
# tools/make_question_file.py).
VOWELS = {"aa", "ae", "ah", "ao", "aw", "ax", "ay", "eh", "er", "ey",
          "ih", "iy", "ow", "oy", "uh", "uw"}
CLASSES = {
    "b": "plosive", "d": "plosive", "g": "plosive", "p": "plosive",
    "t": "plosive", "k": "plosive", "ch": "affricate",
    "jh": "affricate", "dh": "fricative", "f": "fricative",
    "s": "fricative", "sh": "fricative", "th": "fricative",
    "v": "fricative", "z": "fricative", "zh": "fricative",
    "hh": "fricative", "m": "nasal", "n": "nasal", "ng": "nasal",
    "l": "liquid", "r": "liquid", "w": "liquid", "y": "liquid",
    "sil": "silence", "pau": "silence", "sp": "silence",
}

# Ordered longest-match-first letter-to-sound rules (compact English
# grapheme->ARPABET; intelligible fallback, not a lexicon replacement).
_LTS_RULES = [
    ("tion", ["sh", "ah", "n"]), ("sion", ["zh", "ah", "n"]),
    ("ough", ["ow"]), ("augh", ["ao"]), ("eigh", ["ey"]),
    ("igh", ["ay"]), ("tch", ["ch"]), ("dge", ["jh"]),
    ("sch", ["s", "k"]), ("qu", ["k", "w"]), ("th", ["th"]),
    ("sh", ["sh"]), ("ch", ["ch"]), ("ph", ["f"]), ("wh", ["w"]),
    ("ck", ["k"]), ("ng", ["ng"]), ("gh", ["g"]), ("kn", ["n"]),
    ("wr", ["r"]), ("ee", ["iy"]), ("ea", ["iy"]), ("oo", ["uw"]),
    ("ou", ["aw"]), ("ow", ["ow"]), ("ai", ["ey"]), ("ay", ["ey"]),
    ("oi", ["oy"]), ("oy", ["oy"]), ("au", ["ao"]), ("aw", ["ao"]),
    ("oa", ["ow"]), ("ie", ["iy"]), ("ar", ["aa", "r"]),
    ("er", ["er"]), ("ir", ["er"]), ("ur", ["er"]),
    ("or", ["ao", "r"]),
    ("a", ["ae"]), ("b", ["b"]), ("c", ["k"]), ("d", ["d"]),
    ("e", ["eh"]), ("f", ["f"]), ("g", ["g"]), ("h", ["hh"]),
    ("i", ["ih"]), ("j", ["jh"]), ("k", ["k"]), ("l", ["l"]),
    ("m", ["m"]), ("n", ["n"]), ("o", ["aa"]), ("p", ["p"]),
    ("q", ["k"]), ("r", ["r"]), ("s", ["s"]), ("t", ["t"]),
    ("u", ["ah"]), ("v", ["v"]), ("w", ["w"]), ("x", ["k", "s"]),
    ("y", ["y"]), ("z", ["z"]),
]

_ONES = "zero one two three four five six seven eight nine".split()
_TEENS = ("ten eleven twelve thirteen fourteen fifteen sixteen "
          "seventeen eighteen nineteen").split()
_TENS = ("x x twenty thirty forty fifty sixty seventy eighty "
         "ninety").split()


def _number_to_words(num_str):
    n = int(num_str)
    if n < 10:
        return [_ONES[n]]
    if n < 20:
        return [_TEENS[n - 10]]
    if n < 100:
        words = [_TENS[n // 10]]
        if n % 10:
            words.append(_ONES[n % 10])
        return words
    if n < 1000:
        words = [_ONES[n // 100], "hundred"]
        if n % 100:
            words.extend(_number_to_words(str(n % 100)))
        return words
    if n < 1000000:
        words = _number_to_words(str(n // 1000)) + ["thousand"]
        if n % 1000:
            words.extend(_number_to_words(str(n % 1000)))
        return words
    return [_ONES[int(d)] for d in num_str]


# Common abbreviations (expanded before punctuation handling so the
# trailing period is not read as a phrase break).
_ABBREV = {
    # "no." is deliberately absent: the plain word "no" at sentence end
    # ("She said no.") would be corrupted to "number".
    "mr": "mister", "mrs": "missus", "ms": "miss", "dr": "doctor",
    "st": "saint", "prof": "professor", "jr": "junior",
    "sr": "senior", "etc": "etcetera", "vs": "versus",
    "dept": "department", "govt": "government",
}
_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third",
    "five": "fifth", "eight": "eighth", "nine": "ninth",
    "twelve": "twelfth",
}


def _ordinal_words(num_str):
    words = _number_to_words(num_str)
    last = words[-1]
    if last in _ORDINAL_SPECIAL:
        words[-1] = _ORDINAL_SPECIAL[last]
    elif last.endswith("y"):
        words[-1] = last[:-1] + "ieth"
    else:
        words[-1] = last + "th"
    return words


def _year_words(num_str):
    """Four-digit years in pairs ('1984' -> nineteen eighty four);
    round hundreds/anything else fall back to cardinal reading."""
    n = int(num_str)
    if 1100 <= n <= 1999 and n % 100 == 0:
        return _number_to_words(num_str[:2]) + ["hundred"]
    if (1100 <= n <= 1999 or 2010 <= n <= 2099) and n % 100 != 0:
        tail = _number_to_words(num_str[2:])
        if n % 100 < 10:
            tail = ["oh"] + tail          # 1901 -> nineteen oh one
        return _number_to_words(num_str[:2]) + tail
    return _number_to_words(num_str)


def normalise_text(text):
    """Lowercase, expand abbreviations / currency / percentages /
    ordinals / years / decimals / cardinals, map major punctuation to
    pause markers (the role the reference delegates to Festival's text
    normalisation behind the Text2FestivalReady perl wrappers)."""
    text = text.lower()
    # Abbreviations with their trailing period.
    text = re.sub(
        r"\b(" + "|".join(_ABBREV) + r")\.",
        lambda m: _ABBREV[m.group(1)], text)
    # Currency: $5 / $5.50 -> five dollars / five dollars fifty cents.
    def currency(m):
        whole, cents = m.group(1), m.group(2)
        words = _number_to_words(whole) + [
            "dollar" if whole == "1" else "dollars"]
        if cents:
            words += _number_to_words(cents) + [
                "cent" if cents == "01" else "cents"]
        return " " + " ".join(words) + " "
    text = re.sub(r"\$(\d+)(?:\.(\d{2}))?", currency, text)
    # Percentages.
    text = re.sub(r"(\d+)\s*%",
                  lambda m: " ".join(_number_to_words(m.group(1)))
                  + " percent", text)
    # Ordinals: 1st, 2nd, 3rd, 4th ...
    text = re.sub(r"\b(\d+)(?:st|nd|rd|th)\b",
                  lambda m: " ".join(_ordinal_words(m.group(1))), text)
    # Years (plain 4-digit tokens read in pairs).
    text = re.sub(r"\b(1[1-9]\d\d|20[1-9]\d)\b",
                  lambda m: " ".join(_year_words(m.group(1))), text)
    # Decimals: 3.14 -> three point one four.
    text = re.sub(
        r"\b(\d+)\.(\d+)\b",
        lambda m: " ".join(_number_to_words(m.group(1)) + ["point"]
                           + [_ONES[int(d)] for d in m.group(2)]),
        text)
    # Remaining cardinals (digit groups, commas stripped first).
    text = re.sub(r"(\d),(\d)", r"\1\2", text)
    text = re.sub(r"\d+", lambda m: " ".join(_number_to_words(
        m.group(0))), text)
    text = re.sub(r"[.!?;:]+", " <pau> ", text)
    text = re.sub(r"[^a-z' <>]+", " ", text)
    return [w for w in text.split() if w]


def letter_to_sound(word):
    """Rule-based English grapheme -> ARPABET conversion."""
    word = word.replace("'", "")
    # Silent final e.
    if len(word) > 3 and word.endswith("e") and word[-2] not in "aeiou":
        word = word[:-1]
    # Collapse doubled letters.
    word = re.sub(r"(.)\1", r"\1", word)
    phones = []
    i = 0
    while i < len(word):
        for pattern, out in _LTS_RULES:
            if word.startswith(pattern, i):
                phones.extend(out)
                i += len(pattern)
                break
        else:
            i += 1
    return phones


# The TRAP-BATH split is lexically conditioned (Wells' BATH lexical
# set), not phonological: "pass" broadens to /aa/ in RP but "gas" keeps
# /ae/; "dance" broadens but "hand"/"romantic" do not.  The mapping
# therefore consults word-stem sets and only falls back to the safest
# phonetic generalisations (ae+f/th, ae+s+stop) for unknown words.
_BATH_WORDS = frozenset("""
advance after afternoon answer ask aunt avalanche banana basket bath
behalf blast branch brass broadcast calf cant casket cast caste castle
chance chant class command commander contrast craft daft dance demand
disaster draft draught enchant enhance example fast father flask
france giraffe glance glass graph grasp grass half laugh laughter
last lather mask masquerade mast master nasty overdraft pass past
pastime path photograph plant plaster prance raft rascal rasp
raspberry rather reprimand shaft slant staff stance task telegraph
trance vast
""".split())

# Frequent TRAP words a naive phonetic rule would wrongly broaden.
_TRAP_WORDS = frozenset("""
and band bandit brand camp cancel candle cash cassette chassis
classic classical crass dash drastic elastic embassy enthusiast
expand fancy fantastic gas gasoline grand gymnast gymnastic hand
hassle land lass mass massive math maths pant pants passage passenger
passive plastic rand random romance romantic sand sarcastic stamp
stand tassel
""".split())

_STEM_SUFFIXES = ("ing", "est", "ed", "er", "es", "ly", "s", "")


def _in_word_set(word, vocab):
    """Does ``word`` (or an inflectional stem of it) belong to the
    lexical set?  Handles 's', 'es', 'ed', 'ing', 'er', 'est', 'ly'
    plus the doubled-consonant and dropped-e stem variants."""
    if not word:
        return False
    word = word.rstrip("'").replace("'", "")
    for suffix in _STEM_SUFFIXES:
        if not word.endswith(suffix):
            continue
        stem = word[:-len(suffix)] if suffix else word
        if stem in vocab or stem + "e" in vocab:
            return True
        if len(stem) > 2 and stem[-1] == stem[-2] \
                and stem[:-1] in vocab:
            return True
    return False


def to_received_pronunciation(entry, word=None):
    """US (CMU/ARPABET) pronunciation -> RP-flavoured British variant,
    on the SAME phone inventory so every committed question set keeps
    working.  Deterministic post-lexicon mapping of the two accent
    features that dominate Am/Br intelligibility (the role of the
    reference's unilex British front-end path,
    ``scripts/tts_frontend/English/utt2lab-unilex-rpx.sh`` /
    ``Text2FestivalReadyAm.pl`` choosing the Am voice):

    * **Non-rhoticity** — non-prevocalic /r/ is dropped (coda and
      pre-consonantal r: "car", "park", "fourth"); onset r ("red",
      "around") survives.  Non-primary-stressed "er" centralises to
      the lettER vowel "ax"; primary-stressed "er" stays (the NURSE
      vowel shares the symbol).  Word-final linking r is intentionally
      dropped too: the mapping is per-word, like the lexicon itself.
    * **TRAP-BATH split** — lexically conditioned via the BATH/TRAP
      word sets above when ``word`` is known ("pass" -> /aa/ but "gas"
      keeps /ae/; "dance" broadens but "hand" does not); for unknown
      words only the high-precision phonetic contexts apply ("ae"
      before f/th, or before s+stop as in "-ast"/"-ask" codas).

    ``entry`` and the result are ``[(phone, stress_or_None)]``.
    """
    is_bath = word is not None and _in_word_set(word, _BATH_WORDS)
    is_trap = word is not None and (_in_word_set(word, _TRAP_WORDS)
                                    or word.endswith("astic")
                                    or word.endswith("astics"))
    out = []
    n = len(entry)
    for i, (ph, st) in enumerate(entry):
        nxt = entry[i + 1][0] if i + 1 < n else None
        nxt2 = entry[i + 2][0] if i + 2 < n else None
        if ph == "r" and (nxt is None or nxt not in VOWELS):
            continue                # non-prevocalic r: drop
        if ph == "er" and st != 1 and (nxt is None
                                       or nxt not in VOWELS):
            out.append(("ax", st))
            continue
        if ph == "ae" and not is_trap:
            broaden = False
            if is_bath:
                # Broaden in the BATH-triggering context only (the
                # set is stem-based: "classes" has one BATH vowel).
                broaden = (nxt in ("f", "s", "th")
                           or (nxt in ("n", "m") and nxt2 is not None
                               and nxt2 not in VOWELS))
            else:
                # Unknown word: high-precision contexts only.
                broaden = (nxt in ("f", "th")
                           or (nxt == "s" and nxt2 in ("t", "k", "p")))
            if broaden:
                out.append(("aa", st))
                continue
        out.append((ph, st))
    return out


# -- unilex-rpx phone set ----------------------------------------------
# The reference's British recipes label with the unilex RP phone set
# (``utt2lab-unilex-rpx.sh`` -> ``questions-en-unilex_dnn_600.hed``).
# This inventory is read off the shipped question set asset
# (assets/questions-en-unilex_dnn_600.hed C-* questions); only the
# symbols with an explicit ``<sym>1`` question carry a stress suffix.
UNILEX_VOWELS = frozenset("""
@ @@r @@r1 @r a aa aa1 aer aer1 ai ar e eh ei ei1 eir eir1 i i@ ii ir
iy o oi oo oo1 or ou ou1 ow owr owr1 u uh ur ur1 uu uw
""".split())
_UNILEX_STRESS1 = frozenset(
    {"aa", "aer", "ei", "eir", "oo", "ou", "owr", "@@r", "ur"})

# US /aa/ without r covers both RP LOT ("hot" -> o) and PALM ("father"
# -> aa); LOT is the default, PALM is lexically conditioned.
_PALM_WORDS = frozenset("""
aha bra calm drama father lager llama ma mama palm pa papa psalm spa
saga sonata
""".split())


def _unilex_stress(sym, st):
    return sym + "1" if st == 1 and sym in _UNILEX_STRESS1 else sym

# Centring/r-coloured vowels: US vowel followed by NON-prevocalic /r/
# fuses into one unilex symbol (non-rhotic RP keeps the quality, not
# the /r/): "square" -> eir, "here" -> i@, "cure" -> ur, "far" -> ar.
_UNILEX_R_FUSE = {
    "aa": "ar", "ao": "or", "ow": "or", "aw": "owr", "ay": "aer",
    "eh": "eir", "ey": "eir", "ih": "i@", "iy": "i@", "uh": "ur",
    "uw": "ur", "ah": "@@r",
}

_UNILEX_PLAIN = {
    "ae": "a", "ao": "oo", "aw": "ow", "ay": "ai", "eh": "e",
    "ey": "ei", "ih": "i", "ow": "ou", "oy": "oi", "uh": "u",
    "uw": "uu", "ax": "@",
}

_UNILEX_CONS = {"hh": "h"}


def to_unilex_rpx(entry, word=None):
    """US (CMU/ARPABET) pronunciation -> unilex-rpx symbols, the phone
    set of the reference's British label recipes
    (``utt2lab-unilex-rpx.sh``, ``questions-en-unilex_dnn_600.hed``).
    Applies RP accent features directly on the US entry (TRAP-BATH
    split via the lexical sets above; non-prevocalic /r/ fuses with
    the preceding vowel into the centring/r-coloured unilex symbols
    instead of being dropped), then renames the remaining inventory.
    ``entry`` and the result are ``[(phone, stress_or_None)]``; a
    ``1`` suffix lands on the symbols the question set stresses."""
    is_bath = word is not None and _in_word_set(word, _BATH_WORDS)
    is_trap = word is not None and (_in_word_set(word, _TRAP_WORDS)
                                    or word.endswith("astic")
                                    or word.endswith("astics"))
    is_palm = word is not None and _in_word_set(word, _PALM_WORDS)
    out = []
    n = len(entry)
    i = 0
    while i < n:
        ph, st = entry[i]
        nxt = entry[i + 1][0] if i + 1 < n else None
        nxt_st = entry[i + 1][1] if i + 1 < n else None
        nxt2 = entry[i + 2][0] if i + 2 < n else None
        # vowel + non-prevocalic r -> one centring symbol.
        if (ph in _UNILEX_R_FUSE and nxt == "r"
                and (nxt2 is None or nxt2 not in VOWELS)):
            out.append((_unilex_stress(_UNILEX_R_FUSE[ph], st), st))
            i += 2
            continue
        # vowel + unstressed er (fire, hour) -> aer / owr.
        if (ph in ("ay", "aw") and nxt == "er" and nxt_st != 1
                and (nxt2 is None or nxt2 not in VOWELS)):
            sym = "aer" if ph == "ay" else "owr"
            out.append((_unilex_stress(sym, st), st))
            i += 2
            continue
        if ph == "r" and (nxt is None or nxt not in VOWELS):
            i += 1                    # residual non-prevocalic r
            continue
        if ph == "er":
            if st == 1:
                out.append(("@@r1", st))
            else:
                out.append(("@r", st))
        elif ph == "ah":
            out.append(("uh" if st in (1, 2) else "@", st))
        elif ph == "aa":
            out.append(("aa1" if st == 1 else "aa", st) if is_palm
                       else ("o", st))
        elif ph == "ae":
            broaden = False
            if not is_trap:
                if is_bath:
                    broaden = (nxt in ("f", "s", "th")
                               or (nxt in ("n", "m") and nxt2 is not None
                                   and nxt2 not in VOWELS))
                else:
                    broaden = (nxt in ("f", "th")
                               or (nxt == "s"
                                   and nxt2 in ("t", "k", "p")))
            if broaden:
                out.append((_unilex_stress("aa", st), st))
            else:
                out.append(("a", st))
        elif ph == "iy":
            # happY: word-final unstressed FLEECE reduces to iy.
            if st != 1 and i == n - 1:
                out.append(("iy", st))
            else:
                out.append(("ii", st))
        elif ph in _UNILEX_PLAIN:
            out.append((_unilex_stress(_UNILEX_PLAIN[ph], st), st))
        elif ph in VOWELS:
            out.append((ph, st))
        else:
            out.append((_UNILEX_CONS.get(ph, ph), st))
        i += 1
    return out


_ACCENT_MAPS = {
    "en-us": None,
    "en-gb": to_received_pronunciation,
    "unilex-rpx": to_unilex_rpx,
    "en-gb-unilex": to_unilex_rpx,
}


def load_lexicon(path, keep_stress=False):
    """CMU-dictionary-format lexicon: ``WORD  PH1 PH2 ...`` (``;;;``
    comments skipped).  Stress digits are stripped; with
    ``keep_stress`` entries are ``[(phone, stress_digit_or_None)]``
    (0 = unstressed, 1 = primary, 2 = secondary on vowel nuclei)."""
    lex = {}
    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            if not line.strip() or line.startswith(";;;"):
                continue
            parts = line.split()
            word = re.sub(r"\(\d+\)$", "", parts[0]).lower()
            if word in lex:
                continue
            entry = []
            for p in parts[1:]:
                m = re.search(r"(\d)", p)
                entry.append((re.sub(r"\d", "", p).lower(),
                              int(m.group(1)) if m else None))
            lex[word] = entry if keep_stress \
                else [ph for ph, _ in entry]
    return lex


# --- morphological lookup -------------------------------------------------
# Regular English inflection/derivation is phonologically predictable,
# so a lexicon of lemmas covers far more surface forms than its line
# count: "dances/danced/dancing/dancer/dancers" all resolve through the
# "dance" entry.  This is how dictionary front ends (Festival's
# lex.add.entry + LTS hybrid) achieve their coverage without storing
# every form.

_SIBILANTS = {"s", "z", "sh", "zh", "ch", "jh"}
_VOICELESS = {"p", "t", "k", "f", "th", "s", "sh", "ch", "hh"}


def _sfx_plural(entry):
    """-s / -es / possessive 's: [z] after voiced, [s] after voiceless,
    [ih z] after sibilants."""
    last = entry[-1][0]
    if last in _SIBILANTS:
        return entry + [("ih", 0), ("z", None)]
    if last in _VOICELESS:
        return entry + [("s", None)]
    return entry + [("z", None)]


def _sfx_past(entry):
    """-ed: [ih d] after t/d, [t] after voiceless, [d] after voiced."""
    last = entry[-1][0]
    if last in ("t", "d"):
        return entry + [("ih", 0), ("d", None)]
    if last in _VOICELESS:
        return entry + [("t", None)]
    return entry + [("d", None)]


def _stem_candidates(word, strip, add=("",)):
    """Orthographic stems for ``word`` minus ``strip`` letters: the
    plain stem, the dropped-e restoration, and the un-doubled final
    consonant ("stopped" -> "stop", "dancing" -> "dance")."""
    stem = word[:-strip] if strip else word
    out = []
    for suffix in add:
        out.append(stem + suffix)
    if len(stem) >= 3 and stem[-1] == stem[-2] and stem[-1] not in "aeiouls":
        out.append(stem[:-1])
    return out

# (suffix, strip_extra_candidates, phone_fn) tried in order.  phone_fn
# maps the stem entry to the inflected entry.
_SUFFIX_RULES = [
    ("ies", lambda w: [w[:-3] + "y"], _sfx_plural),
    ("ied", lambda w: [w[:-3] + "y"], _sfx_past),
    ("ves", lambda w: [w[:-3] + "f", w[:-3] + "fe"], _sfx_plural),
    ("'s", lambda w: [w[:-2]], _sfx_plural),
    ("s'", lambda w: [w[:-2]], _sfx_plural),
    ("es", lambda w: _stem_candidates(w, 2) + [w[:-1]], _sfx_plural),
    ("s", lambda w: [w[:-1]], _sfx_plural),
    ("ed", lambda w: _stem_candidates(w, 2, add=("", "e")), _sfx_past),
    ("ing", lambda w: _stem_candidates(w, 3, add=("", "e")),
     lambda e: e + [("ih", 0), ("ng", None)]),
    ("ier", lambda w: [w[:-3] + "y"],
     lambda e: e + [("er", 0)]),
    ("iest", lambda w: [w[:-4] + "y"],
     lambda e: e + [("iy", 0), ("ih", 0), ("s", None), ("t", None)]),
    ("er", lambda w: _stem_candidates(w, 2, add=("", "e")),
     lambda e: e + [("er", 0)]),
    ("est", lambda w: _stem_candidates(w, 3, add=("", "e")),
     lambda e: e + [("ih", 0), ("s", None), ("t", None)]),
    ("ily", lambda w: [w[:-3] + "y"],
     lambda e: e[:-1] + [("ax", 0), ("l", None), ("iy", 0)]
     if e and e[-1][0] == "iy" else e + [("l", None), ("iy", 0)]),
    ("ly", lambda w: [w[:-2]],
     lambda e: e + [("l", None), ("iy", 0)]),
    ("ness", lambda w: [w[:-4], w[:-4] + "e"],
     lambda e: e + [("n", None), ("ax", 0), ("s", None)]),
    ("ment", lambda w: [w[:-4], w[:-4] + "e"],
     lambda e: e + [("m", None), ("ax", 0), ("n", None), ("t", None)]),
    ("ful", lambda w: [w[:-3], w[:-3] + "e"],
     lambda e: e + [("f", None), ("ax", 0), ("l", None)]),
    ("less", lambda w: [w[:-4], w[:-4] + "e"],
     lambda e: e + [("l", None), ("ax", 0), ("s", None)]),
    ("able", lambda w: [w[:-4], w[:-4] + "e"],
     lambda e: e + [("ax", 0), ("b", None), ("ax", 0), ("l", None)]),
]

# Transparent prefixes: pronunciation = prefix phones + base entry.
_PREFIX_RULES = [
    ("un", [("ah", 2), ("n", None)]),
    ("non", [("n", None), ("aa", 2), ("n", None)]),
    ("re", [("r", None), ("iy", 2)]),
    ("dis", [("d", None), ("ih", 2), ("s", None)]),
    ("mis", [("m", None), ("ih", 2), ("s", None)]),
    ("pre", [("p", None), ("r", None), ("iy", 2)]),
    ("over", [("ow", 2), ("v", None), ("er", 0)]),
    ("under", [("ah", 2), ("n", None), ("d", None), ("er", 0)]),
    ("out", [("aw", 2), ("t", None)]),
    ("semi", [("s", None), ("eh", 2), ("m", None), ("iy", 0)]),
    ("anti", [("ae", 2), ("n", None), ("t", None), ("iy", 0)]),
    ("super", [("s", None), ("uw", 2), ("p", None), ("er", 0)]),
]


def morphological_lookup(word, lexicon, depth=2):
    """Resolve an out-of-lexicon ``word`` as lemma + regular affixes.
    Returns ``[(phone, stress)]`` or None.  ``depth`` allows one
    recursion so stacked affixes resolve ("unhelpfully" -> un + help +
    ful + ly)."""
    if depth <= 0:
        return None

    def resolve(stem):
        entry = lexicon.get(stem)
        if entry is not None:
            return list(entry)
        return morphological_lookup(stem, lexicon, depth - 1)

    for suffix, stems_fn, phone_fn in _SUFFIX_RULES:
        if not word.endswith(suffix) or len(word) <= len(suffix) + 1:
            continue
        for stem in stems_fn(word):
            if len(stem) < 2:
                continue
            entry = resolve(stem)
            if entry is not None:
                return phone_fn(entry)
    for prefix, phones in _PREFIX_RULES:
        if word.startswith(prefix) and len(word) > len(prefix) + 2:
            entry = resolve(word[len(prefix):])
            if entry is not None:
                return list(phones) + entry
    return None


def syllabify(phones_with_stress):
    """[(phone, stress_or_None)] for ONE word -> list of syllables
    ``{"phones": [...], "stress": 0|1|2}``: every vowel is a nucleus;
    a single intervocalic consonant starts the next syllable (onset
    maximisation: wa-ter), larger clusters split evenly (win-ter),
    trailing consonants close the last syllable.  A word without a
    vowel is one unstressed syllable."""
    nuclei = [i for i, (p, _) in enumerate(phones_with_stress)
              if p in VOWELS or p in UNILEX_VOWELS]
    if not nuclei:
        return [{"phones": [p for p, _ in phones_with_stress],
                 "stress": 0}]
    syllables = []
    start = 0
    for n, nuc in enumerate(nuclei):
        end = (len(phones_with_stress) if n + 1 == len(nuclei)
               else nuclei[n] + 1 + max(
                   0, (nuclei[n + 1] - nuclei[n] - 1) // 2))
        chunk = phones_with_stress[start:end]
        stress = phones_with_stress[nuc][1]
        syllables.append({"phones": [p for p, _ in chunk],
                          "stress": int(stress or 0)})
        start = end
    return syllables


# Bundled curated US-English lexicon (CMU format); the builtin front
# end defaults to it so common words get dictionary pronunciations
# instead of rule LTS (the role Festival's lexicon plays for the
# reference, scripts/tts_frontend/English/makeLabels.sh).
DEFAULT_LEXICON = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "lexicon-en-us.dict")


class BuiltinFrontEnd:
    """Text -> phrases -> words -> syllables -> full-context labels."""

    def __init__(self, lexicon_path=None, accent="en-US"):
        """``lexicon_path``: CMU-format dictionary.  ``None`` loads the
        bundled ``assets/lexicon-en-us.dict``; pass ``""`` (or any
        falsy non-None value) to run pure rule LTS.  ``accent``:
        ``"en-US"`` (default, General American / ARPABET) or
        ``"en-GB"`` (RP-flavoured via
        :func:`to_received_pronunciation`, same ARPABET inventory) or
        ``"unilex-rpx"`` (RP on the unilex symbol inventory of
        ``questions-en-unilex_dnn_600.hed`` via :func:`to_unilex_rpx`,
        with ``#`` utterance silences — the label dialect of the
        reference's British recipes) — the builtin counterparts of the
        reference's Festival Am/Br front-end variants
        (``Text2FestivalReadyAm.pl`` vs ``utt2lab-unilex-rpx.sh``)."""
        if lexicon_path is None and os.path.isfile(DEFAULT_LEXICON):
            lexicon_path = DEFAULT_LEXICON
        self.lexicon = (load_lexicon(lexicon_path, keep_stress=True)
                        if lexicon_path else {})
        key = (accent or "en-US").lower().replace("_", "-")
        if key not in _ACCENT_MAPS:
            raise ValueError("unknown accent %r (supported: %s)"
                             % (accent, sorted(_ACCENT_MAPS)))
        self.accent = key
        self._accent_map = _ACCENT_MAPS[key]
        # unilex labels mark utterance silence '#' (questions C-#).
        self.sil_phone = "#" if self._accent_map is to_unilex_rpx \
            else "sil"

    def _lookup(self, word):
        """[(phone, stress)] — lexicon with CMU stress digits, or the
        letter-to-sound fallback with primary stress on the first
        vowel (Festival's LTS default for unknown words)."""
        entry = self.lexicon.get(word)
        if entry is None and self.lexicon:
            # Lemma + regular affixes before rule LTS: "dancers"
            # resolves through the "dance" entry.
            entry = morphological_lookup(word, self.lexicon)
        if entry is not None:
            out = list(entry)
        else:
            phones = letter_to_sound(word)
            out, stressed = [], False
            for ph in phones:
                if ph in VOWELS and not stressed:
                    out.append((ph, 1))
                    stressed = True
                else:
                    out.append((ph, 0 if ph in VOWELS else None))
        if self._accent_map is not None:
            out = self._accent_map(out, word=word)
        return out

    def text_to_structure(self, text):
        """Utterance structure: list of phrases (split at major
        punctuation), each a list of words, each a list of
        ``syllabify`` syllables."""
        phrases, current = [], []
        for word in normalise_text(text):
            if word == "<pau>":
                if current:
                    phrases.append(current)
                    current = []
                continue
            syls = syllabify(self._lookup(word))
            if syls:
                current.append(syls)
        if current:
            phrases.append(current)
        return phrases

    def text_to_phones(self, text):
        """Returns [(phone, word_idx), ...] including boundary sil and
        inter-phrase pau."""
        out = [(self.sil_phone, -1)]
        widx = 0
        for p, phrase in enumerate(self.text_to_structure(text)):
            if p > 0:
                out.append(("pau", -1))
            for word in phrase:
                for syl in word:
                    for ph in syl["phones"]:
                        out.append((ph, widx))
                widx += 1
        out.append((self.sil_phone, -1))
        return out

    @staticmethod
    def _phone_class(phone):
        if phone in VOWELS or phone in UNILEX_VOWELS:
            return "v", "vowel"
        if phone == "h":
            return "c", "fricative"
        if phone == "#":
            return "c", "silence"
        return "c", CLASSES.get(phone, "other")

    def text_to_full_labels(self, text):
        """Full-context label lines (no timings), one per phone.

        Format (the committed question set
        ``assets/questions-en-arpabet_dnn.hed`` is generated for it —
        the numeric-context coverage of the reference's shipped
        questions-en-radio_dnn_416.hed CQS block, on the framework's
        label syntax)::

          ll~l-c+r=rr:PF_PB            phone position in utterance
          /A/vc_class                  phone type
          /B/S!SF-SB@SP                syl stress, pos in word, #phones
          /C/WS_WF-WB                  word #syls, pos in phrase
          /D/PW=PF+PB                  phrase #words, pos in utterance
          /E/EB&EA                     stressed syls before/after in
                                       phrase
          /J/NS~NW+NP-WI               utterance totals + word index

        Silence/pause phones carry 0 in every numeric field (the
        reference uses ``xx``; 0 keeps every CQS well-defined)."""
        structure = self.text_to_structure(text)

        # Flatten to per-phone context records.
        recs = []   # (phone, syl_ctx or None)
        sil = {"stress": 0, "syl_fw": 0, "syl_bw": 0, "syl_len": 0,
               "word_syls": 0, "word_fw": 0, "word_bw": 0,
               "phr_words": 0, "phr_fw": 0, "phr_bw": 0,
               "stressed_before": 0, "stressed_after": 0, "widx": 0}
        recs.append((self.sil_phone, dict(sil)))
        num_phrases = len(structure)
        num_words = sum(len(p) for p in structure)
        num_syls = sum(len(w) for p in structure for w in p)
        widx = 0
        for pi, phrase in enumerate(structure):
            if pi > 0:
                recs.append(("pau", dict(sil)))
            stress_flags = [s["stress"] in (1, 2)
                            for w in phrase for s in w]
            si_in_phrase = 0
            for wi, word in enumerate(phrase):
                widx += 1
                for si, syl in enumerate(word):
                    ctx = {
                        "stress": syl["stress"],
                        "syl_fw": si + 1,
                        "syl_bw": len(word) - si,
                        "syl_len": len(syl["phones"]),
                        "word_syls": len(word),
                        "word_fw": wi + 1,
                        "word_bw": len(phrase) - wi,
                        "phr_words": len(phrase),
                        "phr_fw": pi + 1,
                        "phr_bw": num_phrases - pi,
                        "stressed_before": sum(
                            stress_flags[:si_in_phrase]),
                        "stressed_after": sum(
                            stress_flags[si_in_phrase + 1:]),
                        "widx": widx,
                    }
                    si_in_phrase += 1
                    for ph in syl["phones"]:
                        recs.append((ph, ctx))
        recs.append((self.sil_phone, dict(sil)))

        num = len(recs)
        lines = []
        for i, (c, ctx) in enumerate(recs):
            def at(j):
                return recs[j][0] if 0 <= j < num else "xx"
            vc, cls = self._phone_class(c)
            lines.append(
                "{ll}~{l}-{c}+{r}={rr}:{pfw}_{pbw}"
                "/A/{vc}_{cls}"
                "/B/{stress}!{syl_fw}-{syl_bw}@{syl_len}"
                "/C/{word_syls}_{word_fw}-{word_bw}"
                "/D/{phr_words}={phr_fw}+{phr_bw}"
                "/E/{stressed_before}&{stressed_after}"
                "/J/{ns}~{nw}+{np}-{widx}".format(
                    ll=at(i - 2), l=at(i - 1), c=c, r=at(i + 1),
                    rr=at(i + 2), pfw=i + 1, pbw=num - i, vc=vc,
                    cls=cls, ns=num_syls, nw=num_words,
                    np=num_phrases, **ctx))
        return lines

    def write_labels(self, input_strings, out_dir):
        """Write ``utt%03d.lab`` phone-level full-context label files;
        returns the id list (TTSModel front-end contract)."""
        os.makedirs(out_dir, exist_ok=True)
        ids = []
        for i, text in enumerate(input_strings):
            uid = "utt{:03d}".format(i)
            with open(os.path.join(out_dir, uid + ".lab"), "w") as f:
                f.write("\n".join(self.text_to_full_labels(text)) + "\n")
            ids.append(uid)
        return ids
