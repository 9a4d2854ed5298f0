"""Token/phoneme vocabulary encoder (the port's own copy of the JAX
package's ``utils/text/token_encoder.py``).

Parity target: reference utils/text/text_encoder.py (TokenTextEncoder,
:120-306): reserved ids <pad>=0, <EOS>=1, <UNK>=2, |=3 (SEG); OOV -> <UNK>;
decode strips padding/EOS; silence-phoneme detection for Korean jamo.
"""

from __future__ import annotations

import json
import re

PAD, EOS, UNK, SEG = "<pad>", "<EOS>", "<UNK>", "|"
RESERVED_TOKENS = [PAD, EOS, UNK, SEG]

# Hangul jamo ranges (leads, vowels, tails) — the valid phoneme symbols.
_JAMO_LEADS = {chr(c) for c in range(0x1100, 0x1113)}
_JAMO_VOWELS = {chr(c) for c in range(0x1161, 0x1176)}
_JAMO_TAILS = {chr(c) for c in range(0x11A8, 0x11C3)}
JAMO_SYMBOLS = _JAMO_LEADS | _JAMO_VOWELS | _JAMO_TAILS

_HANGUL_RE = re.compile(u"[㄰-㆏가-힣]+")


def is_hangul(s: str) -> bool:
    if s in JAMO_SYMBOLS:
        return True
    return bool(_HANGUL_RE.findall(s))


def is_sil_phoneme(p: str) -> bool:
    return p == "" or not (p[0].isalpha() or is_hangul(p[0]))


class TokenTextEncoder:
    """Vocabulary from an explicit token list; reserved tokens prepended
    unless already present."""

    def __init__(self, vocab_list: list[str]):
        tokens = list(RESERVED_TOKENS)
        for t in vocab_list:
            if t not in tokens:
                tokens.append(t)
        self.id_to_token = dict(enumerate(tokens))
        self.token_to_id = {t: i for i, t in self.id_to_token.items()}
        self.pad_index = self.token_to_id[PAD]
        self.eos_index = self.token_to_id[EOS]
        self.unk_index = self.token_to_id[UNK]
        self.seg_index = self.token_to_id[SEG]

    def __len__(self) -> int:
        return len(self.id_to_token)

    @property
    def vocab_size(self) -> int:
        return len(self.id_to_token)

    def encode(self, s: str | list[str]) -> list[int]:
        tokens = s.strip().split() if isinstance(s, str) else list(s)
        return [self.token_to_id.get(t, self.unk_index) for t in tokens]

    def decode(self, ids, strip_eos: bool = False, strip_padding: bool = False) -> str:
        ids = list(ids)
        if strip_padding and self.pad_index in ids:
            ids = ids[: ids.index(self.pad_index)]
        if strip_eos and self.eos_index in ids:
            ids = ids[: ids.index(self.eos_index)]
        return " ".join(self.id_to_token.get(int(i), UNK) for i in ids)

    def sil_phonemes(self) -> list[str]:
        return [t for t in self.token_to_id if is_sil_phoneme(t)]

    def store_to_file(self, path: str):
        with open(path, "w") as f:
            json.dump(list(self.id_to_token.values()), f, ensure_ascii=False)

    @classmethod
    def from_file(cls, path: str) -> "TokenTextEncoder":
        with open(path) as f:
            return cls(json.load(f))


def build_token_encoder(token_list_file: str) -> TokenTextEncoder:
    return TokenTextEncoder.from_file(token_list_file)
