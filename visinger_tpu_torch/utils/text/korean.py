"""Korean text utilities: Hangul jamo decomposition + singing-voice text
normalization (the port's own copy of the JAX package's
``utils/text/korean.py``).

Replaces the reference's g2pk/jamo dependency chain
(preprocessor/text/ko_sing.py) with self-contained code:
  - syllable -> (lead, vowel, tail) jamo via Unicode codepoint arithmetic
    (replaces jamo.h2j / h2j-based splitting)
  - number -> Hangul reading (sino-Korean), basic Latin-letter reading —
    the normalization role of the reference's korean.json dictionaries
  - the onset/nucleus/coda syllable split used by the 3-frame rule

Pronunciation rules (liaison, nasal assimilation, palatalization, ㅎ rules,
lateralization, tensification, coda neutralization) live in g2p_ko.py and
are applied by try_g2p; when a `g2pk` package is importable it takes
precedence (same hook point as the reference).
"""

from __future__ import annotations

import re

_HANGUL_BASE = 0xAC00
_N_LEADS, _N_VOWELS, _N_TAILS = 19, 21, 28
_LEAD_BASE, _VOWEL_BASE, _TAIL_BASE = 0x1100, 0x1161, 0x11A7

# jamo compatibility: lead index -> U+1100 block, vowel -> U+1161, tail -> U+11A8

_SINO_DIGITS = ["", "일", "이", "삼", "사", "오", "육", "칠", "팔", "구"]
_SINO_UNITS = ["", "십", "백", "천"]
_SINO_GROUPS = ["", "만", "억", "조", "경"]

_LATIN_READING = {
    "a": "에이", "b": "비", "c": "씨", "d": "디", "e": "이", "f": "에프",
    "g": "지", "h": "에이치", "i": "아이", "j": "제이", "k": "케이",
    "l": "엘", "m": "엠", "n": "엔", "o": "오", "p": "피", "q": "큐",
    "r": "알", "s": "에스", "t": "티", "u": "유", "v": "브이", "w": "더블유",
    "x": "엑스", "y": "와이", "z": "제트",
}


def is_hangul_syllable(ch: str) -> bool:
    return _HANGUL_BASE <= ord(ch) < _HANGUL_BASE + _N_LEADS * _N_VOWELS * _N_TAILS


def decompose_syllable(ch: str) -> tuple[str, str, str | None]:
    """'한' -> (lead, vowel, tail or None) as U+11xx jamo characters."""
    if not is_hangul_syllable(ch):
        raise ValueError(f"not a Hangul syllable: {ch!r}")
    code = ord(ch) - _HANGUL_BASE
    lead = code // (_N_VOWELS * _N_TAILS)
    vowel = (code % (_N_VOWELS * _N_TAILS)) // _N_TAILS
    tail = code % _N_TAILS
    return (
        chr(_LEAD_BASE + lead),
        chr(_VOWEL_BASE + vowel),
        chr(_TAIL_BASE + tail) if tail else None,
    )


def syllable_to_phonemes(ch: str) -> list[str]:
    """Syllable -> 1-3 jamo phonemes (onset, nucleus[, coda])."""
    lead, vowel, tail = decompose_syllable(ch)
    out = [lead, vowel]
    if tail is not None:
        out.append(tail)
    return out


def number_to_hangul(num: int) -> str:
    """Sino-Korean number reading (basic; covers the lyric use case)."""
    if num == 0:
        return "영"
    if num < 0:
        return "마이너스 " + number_to_hangul(-num)
    groups = []
    while num:
        groups.append(num % 10000)
        num //= 10000
    parts = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            continue
        s = ""
        for ui in range(3, -1, -1):
            d = (g // 10 ** ui) % 10
            if d == 0:
                continue
            digit = "" if (d == 1 and ui > 0) else _SINO_DIGITS[d]
            s += digit + _SINO_UNITS[ui]
        if gi >= 1 and s == "일":  # 일만 -> 만 (drop the leading 일)
            s = ""
        parts.append(s + _SINO_GROUPS[gi])
    return "".join(parts)


# ---------------------------------------------------------------------------
# Number normalization — parity with the reference's num_to_hangeul +
# korean.json dictionaries (preprocessor/text/ko_sing.py:82-165):
#   - measurement units replaced before number reading (unit_dict)
#   - native-Korean count readings (한/두/세... 열/스물/서른...) when a
#     1-2-digit integer precedes a counter word (count_checker/count_dict/
#     count_tenth_dict)
#   - floats: integer part + "쩜 " + digit-by-digit fraction
#   - signs: 플러스/마이너스 prefixes
#   - leading zeros read as 공 per zero ("007" -> 공공칠)
# Documented intended-behavior fixes vs the reference:
#   - its leading-zero branch calls the nonexistent str.startwith (crashes on
#     ANY multi-digit number) and counts every zero, not just leading ones;
#   - its 만-group order lists 해 before 경 (standard is ..조, 경, 해);
#   - its normalize_english tests `word in dict` (the builtin) — a no-op; we
#     read Latin via the letter table below instead.
# ---------------------------------------------------------------------------

_UNIT_WORDS = {"%": "퍼센트", "ml": "밀리리터", "mm": "밀리미터",
               "cm": "센치미터", "km": "킬로미터", "kg": "킬로그램",
               "℃": "도", "㎢": "제곱킬로미터", "㎥": "세제곱미터",
               "m": "미터"}
# counter words that take native-Korean readings (reference count_checker)
_COUNT_UNITS = ("시|명|가지|살|마리|포기|송이|수|톨|통|점|개(?!월)|벌|척|채|"
                "다발|그루|자루|줄|켤레|그릇|잔|마디|상자|사람|곡|병|판")
_NATIVE_ONES = ["", "한", "두", "세", "네", "다섯", "여섯", "일곱", "여덟",
                "아홉"]
_NATIVE_TENS = {1: "열", 2: "스물", 3: "서른", 4: "마흔", 5: "쉰",
                6: "예순", 7: "일흔", 8: "여든", 9: "아흔"}

_NUM_PAT = r"([+-]?\d{1,3}(?:,\d{3})+(?!\d)|[+-]?\d+)(\.\d+)?"
# no whitespace between number and counter — the reference's count_checker
# requires adjacency (ko_sing.py count patterns), so "3 개" reads sino
_COUNT_RE = re.compile(_NUM_PAT + r"(" + _COUNT_UNITS + r")")
_PLAIN_NUM_RE = re.compile(_NUM_PAT)


def number_to_hangul_native(n: int) -> str:
    """Native-Korean counting reading for 0..99 (한, 두, ... 스물하나 식)."""
    if not 0 <= n < 100:
        raise ValueError(f"native reading covers 0-99, got {n}")
    if n == 0:
        return "영"
    tens, ones = divmod(n, 10)
    return _NATIVE_TENS.get(tens, "") + _NATIVE_ONES[ones]


def read_number(int_part: str, frac: str | None = None,
                is_count: bool = False) -> str:
    """One matched number -> Hangul reading (reference num_to_hangeul)."""
    s = int_part.replace(",", "")
    prefix = ""
    if s and s[0] in "+-":
        prefix = "플러스 " if s[0] == "+" else "마이너스 "
        s = s[1:]
    zeros = ""
    if len(s) > 1 and s.startswith("0") and not frac:
        stripped = s.lstrip("0")
        zeros = "공" * (len(s) - len(stripped))
        s = stripped or "0"
    if is_count and (frac or len(s) > 2):
        # counts are small native-Korean integers; anything else reads sino
        # (reference flips is_count off for >2 digits and raises on floats)
        is_count = False
    n = int(s or "0")
    if is_count:
        kor = number_to_hangul_native(n)
    else:
        kor = number_to_hangul(n)
    if frac:
        digits = frac.lstrip(".")
        kor = ("영" if n == 0 and not zeros else kor) + "쩜 " + "".join(
            _SINO_DIGITS[int(d)] if d != "0" else "영" for d in digits)
    return prefix + zeros + kor


def normalize_text(text: str) -> str:
    """Lyric normalization: measurement units, numbers (native-Korean count
    readings before counter words, sino otherwise, floats, signs) and Latin
    letters -> Hangul readings; strip everything that is neither Hangul nor
    space."""
    for unit, word in _UNIT_WORDS.items():
        text = text.replace(unit, word)
    text = _COUNT_RE.sub(
        lambda m: read_number(m.group(1), m.group(2), is_count=True)
        + m.group(3), text)
    text = _PLAIN_NUM_RE.sub(
        lambda m: read_number(m.group(1), m.group(2)), text)
    text = "".join(
        _LATIN_READING.get(c.lower(), c) if c.isascii() and c.isalpha() else c
        for c in text
    )
    text = re.sub(r"[^가-힣\s]", "", text)
    return re.sub(r"\s+", " ", text).strip()


_G2P_EXTERNAL = None


def try_g2p(text: str) -> str:
    """Apply Korean pronunciation rules: the g2pk package when importable
    (the reference's tool, ko_sing.py:5,176), otherwise the native
    rule engine (utils/text/g2p_ko.py — liaison, nasal assimilation,
    palatalization, ㅎ rules, lateralization, tensification, coda
    neutralization).  Length-preserving either way."""
    global _G2P_EXTERNAL
    if _G2P_EXTERNAL is None:
        try:
            from g2pk import G2p  # type: ignore

            _G2P_EXTERNAL = G2p()
        except ImportError:
            _G2P_EXTERNAL = False
    if _G2P_EXTERNAL:
        return _G2P_EXTERNAL(text)
    from visinger_tpu_torch.utils.text.g2p_ko import g2p_syllables

    return g2p_syllables(text)
