"""ftfy-equivalent text repair for the CLIP tokenizer — the port's copy of
``clip_codec_tpu/encoders/textclean.py``.

open_clip's ``basic_clean`` is ``ftfy.fix_text`` + double ``html.unescape``.
ftfy is not a dependency, so this module implements the ``fix_text``
default pipeline for the cases that occur in scraped caption text, in
ftfy's documented order:

1. mojibake repair — UTF-8 bytes mis-decoded as windows-1252/latin-1
   ("CafÃ©" -> "Café"), including the double-encoded case, using the
   "sloppy windows-1252" byte map and a conservative gating heuristic;
2. terminal-escape removal (ANSI sequences);
3. character-width normalization (fullwidth forms -> ASCII);
4. latin-ligature expansion (ﬁ -> fi);
5. quote uncurling (’ -> ', “ ” -> ");
6. line-break normalization;
7. lone-surrogate repair (CESU/WTF-8 artifacts -> real code points);
8. control-character removal (keeping \\t \\n);
9. NFC normalization.
"""

from __future__ import annotations

import html
import re
import unicodedata

# --- sloppy windows-1252 -------------------------------------------------
# cp1252 with its five unassigned bytes mapped to the C1 controls, so every
# byte 0x00-0xFF round-trips — exactly ftfy's "sloppy-windows-1252" codec.
_SLOPPY_1252_UNMAPPED = {0x81, 0x8D, 0x8F, 0x90, 0x9D}


def _encode_sloppy_1252(text: str) -> bytes | None:
    out = bytearray()
    for ch in text:
        cp = ord(ch)
        if cp < 0x80:
            out.append(cp)
            continue
        if 0x80 <= cp <= 0x9F and cp in _SLOPPY_1252_UNMAPPED:
            out.append(cp)  # C1 control <-> raw byte
            continue
        try:
            out += ch.encode("cp1252")
        except UnicodeEncodeError:
            if cp <= 0xFF:
                out.append(cp)  # latin-1 fallback (covers C1 + latin-1 gaps)
            else:
                return None
    return bytes(out)


# Mojibake *trigger*: characters that windows-1252-decoded UTF-8 lead bytes
# turn into (Ã Â â Î Ï Ð Ñ ð å æ ç è é ê ë ...) followed by a plausible
# continuation character. Kept conservative: we only attempt a re-decode when
# one of these two-char signatures is present, so legitimate text like
# "Ã la carte" typed deliberately with spaces is left alone ("Ã " does match
# — same trade-off ftfy makes; its heuristic also fires there).
_MOJIBAKE_HINT = re.compile(
    "[Â-ÃÅÎÏÐÑâãð]"  # lead-byte images
    "[-¿ŒœŠšŸŽžƒ"  # continuation images
    "–—‘’‚“”„†‡•"
    "…‰‹›€™ˆ˜ -¿]"
)


def _fix_encoding_once(text: str) -> str:
    """One pass of UTF-8-as-cp1252 repair; returns the input unchanged when
    the gate does not fire or the bytes do not parse as UTF-8."""
    if not _MOJIBAKE_HINT.search(text):
        return text
    raw = _encode_sloppy_1252(text)
    if raw is None:
        return text
    try:
        fixed = raw.decode("utf-8")
    except UnicodeDecodeError:
        return text
    # Plausibility: real repair strictly shrinks the text (multi-char
    # mojibake collapses to one code point). Equal length means nothing was
    # actually multi-byte — keep the original.
    return fixed if len(fixed) < len(text) else text


def fix_encoding(text: str, max_passes: int = 3) -> str:
    """Iteratively repair (possibly nested) UTF-8 / windows-1252 mojibake."""
    for _ in range(max_passes):
        fixed = _fix_encoding_once(text)
        if fixed == text:
            return text
        text = fixed
    return text


# --- the rest of the fix_text pipeline ------------------------------------

_ANSI_RE = re.compile(r"\x1b\[[0-9;?]*[A-Za-z]|\x1b[@-Z\\-_]")

_LIGATURES = {
    "Ĳ": "IJ", "ĳ": "ij", "ﬀ": "ff", "ﬁ": "fi",
    "ﬂ": "fl", "ﬃ": "ffi", "ﬄ": "ffl", "ﬅ": "st",
    "ﬆ": "st",
}

_QUOTES = {
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"', "‟": '"',
    "‹": "'", "›": "'", "«": '"', "»": '"',
}

_LINE_BREAKS = {"\r\n": "\n", "\r": "\n", " ": "\n", " ": "\n",
                "": "\n", "\v": "\n", "\f": "\n"}

_CONTROL_RE = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f-\x9f​﻿]")


def _fix_character_width(text: str) -> str:
    """Fullwidth/halfwidth forms only (NFKC would also mangle ², ½, …)."""
    out = []
    for ch in text:
        if "！" <= ch <= "￮" or ch == "　":
            out.append(unicodedata.normalize("NFKC", ch))
        else:
            out.append(ch)
    return "".join(out)


def _fix_surrogates(text: str) -> str:
    if not any("\ud800" <= c <= "\udfff" for c in text):
        return text
    return text.encode("utf-16", "surrogatepass").decode("utf-16", "replace")


def fix_text(text: str) -> str:
    """ftfy.fix_text's default pipeline (see module docstring). Does NOT
    unescape HTML — the tokenizer's ``basic_clean`` does that separately,
    twice, exactly as open_clip's does."""
    text = _fix_surrogates(text)
    text = fix_encoding(text)
    text = _ANSI_RE.sub("", text)
    text = _fix_character_width(text)
    for src, dst in _LIGATURES.items():
        if src in text:
            text = text.replace(src, dst)
    for src, dst in _QUOTES.items():
        if src in text:
            text = text.replace(src, dst)
    for src, dst in _LINE_BREAKS.items():
        if src in text:
            text = text.replace(src, dst)
    text = _CONTROL_RE.sub("", text)
    return unicodedata.normalize("NFC", text)


def basic_clean(text: str) -> str:
    """open_clip's ``basic_clean``: fix_text then double html.unescape."""
    return html.unescape(html.unescape(fix_text(text))).strip()
