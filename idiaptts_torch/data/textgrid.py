"""Pure-Python Praat TextGrid reader: the port's copy of
``idiaptts_tpu/data/textgrid.py`` (standard library only).

Reads the MFA alignment output that ``data/phonemes.py`` loads.
Supports both the long ("ooTextFile" with ``intervals [k]:`` blocks,
what MFA writes) and the short form, IntervalTier and
TextTier/PointTier.
"""

import re
from collections import namedtuple

Interval = namedtuple("Interval", ["minTime", "maxTime", "mark"])
Point = namedtuple("Point", ["time", "mark"])


class Tier:
    def __init__(self, name, tier_class, minTime, maxTime, entries):
        self.name = name
        self.tier_class = tier_class
        self.minTime = minTime
        self.maxTime = maxTime
        self.entries = entries

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx):
        return self.entries[idx]


class TextGrid:
    def __init__(self, minTime, maxTime, tiers):
        self.minTime = minTime
        self.maxTime = maxTime
        self.tiers = tiers

    def __iter__(self):
        return iter(self.tiers)

    def __len__(self):
        return len(self.tiers)

    def get_tier(self, name):
        for tier in self.tiers:
            if tier.name == name:
                return tier
        raise KeyError(name)

    @staticmethod
    def fromFile(path):
        return read_textgrid(path)


_QUOTED = re.compile(r'"((?:[^"]|"")*)"')
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def _tokenise(text):
    """Yield ('str', s) and ('num', x) tokens in file order.  Works for
    both long form (``key = value`` lines — keys carry no quotes or
    digits that matter because every payload value is either quoted or
    numeric and flag lines like ``tiers? <exists>`` carry neither) and
    short form (bare values)."""
    tokens = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        # Long form: strip a leading "key =" so numbers inside key
        # names (none in practice) can't confuse the scan.
        pos = 0
        while pos < len(line):
            mq = _QUOTED.match(line, pos)
            if mq:
                tokens.append(("str", mq.group(1).replace('""', '"')))
                pos = mq.end()
                continue
            mn = _NUMBER.match(line, pos)
            if mn and (pos == 0 or not line[pos - 1].isalnum()):
                tokens.append(("num", float(mn.group(0))))
                pos = mn.end()
                continue
            pos += 1
    return tokens


def read_textgrid(path):
    """Parse a TextGrid file into a :class:`TextGrid`."""
    with open(path, encoding="utf-8-sig") as f:
        text = f.read()
    tokens = _tokenise(text)
    # Token stream: "ooTextFile" "TextGrid" xmin xmax [size] then per
    # tier: "IntervalTier"|"TextTier" name xmin xmax size then per
    # entry (interval: xmin xmax "text") or (point: time "mark").
    idx = 0

    def next_num():
        nonlocal idx
        while tokens[idx][0] != "num":
            idx += 1
        idx += 1
        return tokens[idx - 1][1]

    def next_str():
        nonlocal idx
        while tokens[idx][0] != "str":
            idx += 1
        idx += 1
        return tokens[idx - 1][1]

    header = next_str()
    if header != "ooTextFile":
        raise ValueError("Not a TextGrid file: " + str(path))
    obj = next_str()
    if obj != "TextGrid":
        raise ValueError("Not a TextGrid object: " + str(path))
    g_min = next_num()
    g_max = next_num()
    num_tiers = int(next_num())

    tiers = []
    for _ in range(num_tiers):
        tier_class = next_str()
        name = next_str()
        t_min = next_num()
        t_max = next_num()
        size = int(next_num())
        entries = []
        if tier_class == "IntervalTier":
            for _ in range(size):
                # Long form repeats the interval index as a number
                # inside "intervals [k]:" — but '[k]' digits follow an
                # alnum guard? No: '[' is not alnum, so k parses as a
                # number.  Intervals therefore contribute either 3
                # (short) or 4 (long, with index) numbers before the
                # text; take the LAST two numbers before each string.
                nums = []
                while tokens[idx][0] == "num":
                    nums.append(tokens[idx][1])
                    idx += 1
                mark = next_str()
                entries.append(Interval(nums[-2], nums[-1], mark))
        else:  # TextTier / PointTier
            for _ in range(size):
                nums = []
                while tokens[idx][0] == "num":
                    nums.append(tokens[idx][1])
                    idx += 1
                mark = next_str()
                entries.append(Point(nums[-1], mark))
        tiers.append(Tier(name, tier_class, t_min, t_max, entries))
    return TextGrid(g_min, g_max, tiers)
