"""Text frontend: CSMSC symbol inventory and phone-string encoding (the
port's own copy of ``msmctts_tpu/utils/text.py``).

The symbol set is the published CSMSC pinyin inventory used by the
reference recipe (examples/csmsc/scripts/text/symbols.py: 3 unspoken +
62 spoken symbols); phone strings are encoded as ``idx_tone_er`` triples
(parse_textgrid.py:22-33): trailing digit -> tone, trailing 'r' (with a
valid base) -> erhua flag.
"""

from __future__ import annotations

PAD = "<PAD>"

UNSPOKEN = [PAD, "sil", "sp1"]

SPOKEN = [
    "a", "ai", "an", "ang", "ao", "b", "c", "ch", "d", "e", "ei", "en", "eng",
    "er", "f", "g", "h", "i", "ia", "ian", "iang", "iao", "ie", "ii", "iii",
    "in", "ing", "io", "iong", "iou", "iyl", "j", "k", "l", "m", "n", "ng",
    "o", "ong", "ou", "p", "pl", "q", "r", "s", "sh", "t", "u", "ua", "uai",
    "uan", "uang", "uei", "uen", "ueng", "uo", "v", "van", "ve", "vn", "x",
    "z", "zh",
]

SYMBOLS = UNSPOKEN + SPOKEN
SYMBOL_TO_ID = {s: i for i, s in enumerate(SYMBOLS)}


def encode_phone(label: str) -> tuple[int, int, int]:
    """One labeled phone (e.g. 'zhang1', 'sil', 'uor3') ->
    (symbol_id, tone, erhua)."""
    phone, tone, er = label, 0, 0
    if phone[:2] != "sp" and phone[-1:].isdigit():
        tone = int(phone[-1])
        phone = phone[:-1]
    if phone != "er" and phone.endswith("r") and phone[:-1] in SYMBOL_TO_ID:
        er = 1
        phone = phone[:-1]
    return SYMBOL_TO_ID[phone], tone, er


def encode_phone_string(labels: list[str]) -> str:
    """Labels -> the book-file payload format 'id_tone_er id_tone_er ...'."""
    return " ".join("_".join(map(str, encode_phone(p))) for p in labels)
