"""Native Korean grapheme-to-phoneme (pronunciation) rules (the port's own
copy of the JAX package's ``utils/text/g2p_ko.py``).

The reference phonemizes lyrics through the external g2pk package
(preprocessor/text/ko_sing.py:5,176 — `G2p()` applied per silence-delimited
word before jamo decomposition).  Where that package is absent, the
standard-Korean phonological rules it applies are implemented natively here, operating on (lead, vowel, tail) jamo index triples:

  - coda neutralization (평폐쇄음화): 7-coda reduction, complex-coda (겹받침)
    simplification
  - liaison (연음): coda resyllabifies onto a following vowel onset,
    complex codas split
  - palatalization (구개음화): ㄷ/ㅌ + 이 -> 지/치
  - ㅎ rules: aspiration merge (ㅎ+ㄱ/ㄷ/ㅈ -> ㅋ/ㅌ/ㅊ, both directions),
    ㅎ deletion before vowels, ㅎ+ㅅ -> ㅆ, ㅎ+ㄴ -> ㄴㄴ
  - nasal assimilation (비음화): ㄱ/ㄷ/ㅂ + ㄴ/ㅁ -> ㅇ/ㄴ/ㅁ, and the
    ㄹ -> ㄴ chain (ㅁ/ㅇ + ㄹ, obstruent + ㄹ)
  - lateralization (유음화): ㄴㄹ / ㄹㄴ -> ㄹㄹ
  - post-obstruent tensification (경음화): ㄱ/ㄷ/ㅂ + ㄱ/ㄷ/ㅂ/ㅅ/ㅈ ->
    tense onset

Rule application is length-preserving (syllable count never changes), which
the pipeline relies on when redistributing converted syllables back to
notes (the reference asserts the same, ko_sing.py:178).  Lexical exceptions
are handled where they can be without a morphological analyzer (g2pk uses
one; it still takes precedence when importable, utils/text/korean.py:try_g2p):
  - 밟- reads its coda as ㅂ before consonants (제10항 단서: 밟다→밥따),
    plus the 넓죽/넓둥 compounds;
  - ㄺ reads as ㄹ before ㄱ with the ㄱ tensified (제11항 단서: 맑게→말께) —
    applied unconditionally, though the standard scopes it to verb stems;
  - compound-word ㄴ-insertion (제29항: 꽃잎→꼰닙) via a lexicon of the
    standard's example compounds (full generality needs morphology).
"""

from __future__ import annotations

_HANGUL_BASE = 0xAC00
_N_VOWELS, _N_TAILS = 21, 28

# compatibility-jamo names for readable tables
_LEADS = "ㄱㄲㄴㄷㄸㄹㅁㅂㅃㅅㅆㅇㅈㅉㅊㅋㅌㅍㅎ"
_TAILS = ["", "ㄱ", "ㄲ", "ㄳ", "ㄴ", "ㄵ", "ㄶ", "ㄷ", "ㄹ", "ㄺ", "ㄻ",
          "ㄼ", "ㄽ", "ㄾ", "ㄿ", "ㅀ", "ㅁ", "ㅂ", "ㅄ", "ㅅ", "ㅆ", "ㅇ",
          "ㅈ", "ㅊ", "ㅋ", "ㅌ", "ㅍ", "ㅎ"]
_L = {c: i for i, c in enumerate(_LEADS)}
_T = {c: i for i, c in enumerate(_TAILS)}

_VOWEL_I = 20  # ㅣ

# complex coda -> (kept coda char, moved/second consonant char)
_COMPLEX = {"ㄳ": ("ㄱ", "ㅅ"), "ㄵ": ("ㄴ", "ㅈ"), "ㄶ": ("ㄴ", "ㅎ"),
            "ㄺ": ("ㄹ", "ㄱ"), "ㄻ": ("ㄹ", "ㅁ"), "ㄼ": ("ㄹ", "ㅂ"),
            "ㄽ": ("ㄹ", "ㅅ"), "ㄾ": ("ㄹ", "ㅌ"), "ㄿ": ("ㄹ", "ㅍ"),
            "ㅀ": ("ㄹ", "ㅎ"), "ㅄ": ("ㅂ", "ㅅ")}

# single-coda 7-consonant neutralization (표준발음법 제8-9항)
_NEUTRAL_SINGLE = {"ㄱ": "ㄱ", "ㄲ": "ㄱ", "ㅋ": "ㄱ",
                   "ㄷ": "ㄷ", "ㅅ": "ㄷ", "ㅆ": "ㄷ", "ㅈ": "ㄷ",
                   "ㅊ": "ㄷ", "ㅌ": "ㄷ", "ㅎ": "ㄷ",
                   "ㅂ": "ㅂ", "ㅍ": "ㅂ",
                   "ㄴ": "ㄴ", "ㄹ": "ㄹ", "ㅁ": "ㅁ", "ㅇ": "ㅇ"}
# complex coda before a consonant / word end (제10-11항; 밟-/ㄺ+ㄱ lexical
# exceptions omitted)
_NEUTRAL_COMPLEX = {"ㄳ": "ㄱ", "ㄵ": "ㄴ", "ㄶ": "ㄴ", "ㄺ": "ㄱ",
                    "ㄻ": "ㅁ", "ㄼ": "ㄹ", "ㄽ": "ㄹ", "ㄾ": "ㄹ",
                    "ㄿ": "ㅂ", "ㅀ": "ㄹ", "ㅄ": "ㅂ"}

_ASPIRATE = {"ㄱ": "ㅋ", "ㄷ": "ㅌ", "ㅈ": "ㅊ", "ㅂ": "ㅍ"}
_TENSE = {"ㄱ": "ㄲ", "ㄷ": "ㄸ", "ㅂ": "ㅃ", "ㅅ": "ㅆ", "ㅈ": "ㅉ"}
_NASALIZE = {"ㄱ": "ㅇ", "ㄷ": "ㄴ", "ㅂ": "ㅁ"}

# ㄴ-insertion lexicon (표준발음법 제29항 example compounds + common words):
# word -> syllable indices whose ㅇ onset becomes ㄴ before the regular
# rules run (the subsequent nasalization/neutralization then produces the
# standard surface form, e.g. 꽃잎 -> 꽃닙 -> 꼰닙).
_N_INSERTION = {
    "솜이불": [1], "홑이불": [1], "막일": [1], "삯일": [1], "맨입": [1],
    "꽃잎": [1], "내복약": [2], "한여름": [1], "남존여비": [2],
    "신여성": [1], "색연필": [1], "직행열차": [2], "늑막염": [2],
    "콩엿": [1], "담요": [1], "눈요기": [1], "영업용": [2], "식용유": [2],
    "밤윷": [1], "물약": [1], "서울역": [2], "휘발유": [2],
}
# vowels that license ㄴ-insertion (이 야 여 요 유)
_N_INSERT_VOWELS = {20, 2, 6, 12, 17}


def _decompose(ch: str):
    code = ord(ch) - _HANGUL_BASE
    if not 0 <= code < 19 * _N_VOWELS * _N_TAILS:
        return None
    return [code // (_N_VOWELS * _N_TAILS),
            (code % (_N_VOWELS * _N_TAILS)) // _N_TAILS,
            code % _N_TAILS]


def _compose(l: int, v: int, t: int) -> str:
    return chr(_HANGUL_BASE + (l * _N_VOWELS + v) * _N_TAILS + t)


def _apply_boundary(cur, nxt):
    """Mutate (cur, nxt) jamo triples across one syllable boundary."""
    tail = _TAILS[cur[2]]
    lead = _LEADS[nxt[0]]

    # --- palatalization (제17항): ㄷ/ㅌ(+ㅎ) + 이 -> 지/치
    if nxt[1] == _VOWEL_I and tail in ("ㄷ", "ㅌ", "ㄾ"):
        if lead == "ㅇ":
            nxt[0] = _L["ㅈ" if tail == "ㄷ" else "ㅊ"]
            cur[2] = _T["ㄹ"] if tail == "ㄾ" else 0
            return
        if lead == "ㅎ" and tail == "ㄷ":  # 닫히다 -> 다치다
            nxt[0] = _L["ㅊ"]
            cur[2] = 0
            return

    # --- ㅎ-coda rules (제12항)
    if tail in ("ㅎ", "ㄶ", "ㅀ"):
        keep = {"ㅎ": 0, "ㄶ": _T["ㄴ"], "ㅀ": _T["ㄹ"]}[tail]
        if lead in _ASPIRATE and lead != "ㅂ":  # ㅎ+ㄱ/ㄷ/ㅈ -> ㅋ/ㅌ/ㅊ
            nxt[0] = _L[_ASPIRATE[lead]]
            cur[2] = keep
            return
        if lead == "ㅅ":  # 좋소 -> 조쏘
            nxt[0] = _L["ㅆ"]
            cur[2] = keep
            return
        if lead == "ㄴ":  # 좋니 -> 존니 / 많네 -> 만네
            cur[2] = keep if keep else _T["ㄴ"]
            return
        if lead == "ㅇ":  # ㅎ deletion: 좋아 -> 조아, 많아 -> 마나
            if keep:  # the surviving consonant liaisons
                nxt[0] = _L[_TAILS[keep]]
            cur[2] = 0
            return

    # --- onset-ㅎ aspiration (제12항 1 [붙임]): 입학 -> 이팍, 축하 -> 추카
    if lead == "ㅎ" and tail:
        if tail in _COMPLEX:
            kept, moved = _COMPLEX[tail]
            if moved in ("ㄱ", "ㄷ", "ㅂ", "ㅈ"):
                nxt[0] = _L[_ASPIRATE[moved]]
                cur[2] = _T[kept]
                return
        plain = _NEUTRAL_SINGLE[tail]
        if plain in _ASPIRATE:
            nxt[0] = _L[_ASPIRATE[plain]]
            cur[2] = 0
            return

    # --- liaison (제13-14항): coda moves onto a vowel onset
    if lead == "ㅇ" and tail and tail != "ㅇ":
        if tail in _COMPLEX:
            kept, moved = _COMPLEX[tail]
            # a moved ㅅ surfaces tense: 없어 -> 업써, 값이 -> 갑씨 (제14항)
            nxt[0] = _L["ㅆ" if moved == "ㅅ" else moved]
            cur[2] = _T[kept]
        else:
            nxt[0] = _L[tail]
            cur[2] = 0
        return

    # --- before a consonant: neutralize the coda first (제8-11항)
    if tail:
        if tail == "ㄼ" and cur[0] == _L["ㅂ"] and cur[1] == 0:
            # 밟- exception (제10항 단서): 밟다 -> 밥따, 밟는 -> 밤는
            cur[2] = _T["ㅂ"]
        elif tail == "ㄼ" and cur[0] == _L["ㄴ"] and cur[1] == 4 \
                and ((lead == "ㅈ" and nxt[1] == 13)
                     or (lead == "ㄷ" and nxt[1] == 13)):
            # 넓죽-/넓둥- compounds (제10항 단서): 넓죽 -> 넙쭉
            cur[2] = _T["ㅂ"]
        elif tail == "ㄺ" and lead == "ㄱ":
            # ㄺ + ㄱ (제11항 단서): 맑게 -> 말께, 묽고 -> 물꼬.  The standard
            # scopes this to verb stems; without morphology it is applied to
            # every ㄺ+ㄱ boundary (g2pk disambiguates via its analyzer).
            cur[2] = _T["ㄹ"]
            nxt[0] = _L["ㄲ"]
            return
        else:
            cur[2] = _T[_NEUTRAL_COMPLEX.get(tail) or _NEUTRAL_SINGLE[tail]]
        orig_tail, tail = tail, _TAILS[cur[2]]
        # 제25항: ㄼ/ㄾ stem codas tensify the following obstruent even after
        # simplifying to ㄹ (넓다 -> 널따, 핥다 -> 할따)
        if orig_tail in ("ㄼ", "ㄾ") and tail == "ㄹ" and lead in _TENSE:
            nxt[0] = _L[_TENSE[lead]]
            return

    # --- lateralization (제20항): ㄴㄹ / ㄹㄴ -> ㄹㄹ
    if tail == "ㄴ" and lead == "ㄹ":
        cur[2] = _T["ㄹ"]
        return
    if tail == "ㄹ" and lead == "ㄴ":
        nxt[0] = _L["ㄹ"]
        return

    # --- nasal assimilation (제18-19항)
    if lead in ("ㄴ", "ㅁ") and tail in _NASALIZE:
        cur[2] = _T[_NASALIZE[tail]]
        return
    if lead == "ㄹ":
        if tail in ("ㅁ", "ㅇ"):  # 종로 -> 종노
            nxt[0] = _L["ㄴ"]
            return
        if tail in _NASALIZE:  # 막론 -> 망논
            nxt[0] = _L["ㄴ"]
            cur[2] = _T[_NASALIZE[tail]]
            return

    # --- post-obstruent tensification (제23항): 국밥 -> 국빱
    if tail in ("ㄱ", "ㄷ", "ㅂ") and lead in _TENSE:
        nxt[0] = _L[_TENSE[lead]]
        return


def g2p_syllables(text: str) -> str:
    """Apply pronunciation rules to a run of Hangul; non-Hangul characters
    pass through and act as rule boundaries.  Length-preserving."""
    out = list(text)
    tris = [_decompose(ch) for ch in out]
    # compound ㄴ-insertion (제29항) from the lexicon, before the regular
    # rules so nasalization/neutralization finish the derivation
    for word, positions in _N_INSERTION.items():
        start = text.find(word)
        while start != -1:
            for p in positions:
                tri = tris[start + p]
                if tri is not None and _LEADS[tri[0]] == "ㅇ" \
                        and tri[1] in _N_INSERT_VOWELS:
                    tri[0] = _L["ㄴ"]
            start = text.find(word, start + 1)
    for i in range(len(out) - 1):
        if tris[i] is not None and tris[i + 1] is not None:
            _apply_boundary(tris[i], tris[i + 1])
    # word/run-final coda neutralization
    for i, tri in enumerate(tris):
        if tri is None:
            continue
        is_final = i == len(tris) - 1 or tris[i + 1] is None
        if is_final and tri[2]:
            tail = _TAILS[tri[2]]
            tri[2] = _T[_NEUTRAL_COMPLEX.get(tail) or _NEUTRAL_SINGLE[tail]]
    return "".join(ch if tri is None else _compose(*tri)
                   for ch, tri in zip(out, tris))
