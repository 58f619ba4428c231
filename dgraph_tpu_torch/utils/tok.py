"""Tokenizers: value → index terms.

Copy of dgraph_tpu/utils/tok.py for the PyTorch port.

Reference semantics: tok/tok.go — registry keyed by a 1-byte identifier that
prefixes every index term (so one index posting space can hold many tokenizer
families, tok/tok.go:34-60); IsSortable drives index-ordered sort
(worker/sort.go sortWithIndex), IsLossy forces post-filter re-checks of
candidates against actual values (worker/task.go:837-919). Full-text uses
per-language stemming + stopwords (tok/fts.go, Bleve); ours is a self-contained
Porter stemmer + English stopword list. Custom tokenizers: the reference loads
Go plugin .so files (tok/tok.go:92-109); here a custom tokenizer is a Python
module registered via register_custom / --custom_tokenizers.

Term bytes returned by tokenize() are exactly what lands in INDEX keys
(storage/keys.py index_key) and therefore define index-bucket sort order:
int/float/datetime tokens are big-endian order-preserving encodings so walking
index buckets in key order IS the sorted order (the sortWithIndex contract).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable

from dgraph_tpu_torch.utils.types import TypeID, Val, convert


@dataclass(frozen=True)
class Tokenizer:
    name: str
    ident: int           # 1-byte term prefix
    type_id: TypeID      # value type it accepts
    sortable: bool
    lossy: bool
    fn: Callable[[Val], list[bytes]]

    def tokens(self, v: Val) -> list[bytes]:
        prefix = bytes([self.ident])
        return [prefix + t for t in self.fn(v)]


_REGISTRY: dict[str, Tokenizer] = {}


def register(t: Tokenizer) -> None:
    if t.name in _REGISTRY:
        raise ValueError(f"duplicate tokenizer {t.name}")
    for existing in _REGISTRY.values():
        if existing.ident == t.ident:
            raise ValueError(f"duplicate tokenizer ident 0x{t.ident:x}")
    _REGISTRY[t.name] = t


def get(name: str) -> Tokenizer:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown tokenizer {name!r}") from None


def has(name: str) -> bool:
    return name in _REGISTRY


def default_tokenizer(tid: TypeID) -> Tokenizer:
    """Tokenizer used when @index has no argument (reference schema/parse.go)."""
    return get({
        TypeID.INT: "int", TypeID.FLOAT: "float", TypeID.BOOL: "bool",
        TypeID.DATETIME: "year", TypeID.GEO: "geo",
        TypeID.STRING: "term", TypeID.DEFAULT: "term",
    }[tid])


# ---------------------------------------------------------------------------
# Scalar encodings (order-preserving big-endian; sortable indexes)
# ---------------------------------------------------------------------------

def _enc_int(v: int) -> bytes:
    if not (-(1 << 63) <= v < (1 << 63)):
        raise ValueError(f"int value {v} outside int64 range")
    return struct.pack(">Q", v + (1 << 63))  # bias: preserves order across sign


def _enc_float(f: float) -> bytes:
    bits = struct.unpack(">Q", struct.pack(">d", f))[0]
    bits = bits ^ ((1 << 63) if bits >> 63 == 0 else 0xFFFFFFFFFFFFFFFF)
    return struct.pack(">Q", bits)


def _int_tokens(v: Val) -> list[bytes]:
    return [_enc_int(int(convert(v, TypeID.INT).value))]


def _float_tokens(v: Val) -> list[bytes]:
    return [_enc_float(float(convert(v, TypeID.FLOAT).value))]


def _bool_tokens(v: Val) -> list[bytes]:
    return [b"\x01" if convert(v, TypeID.BOOL).value else b"\x00"]


def _dt_part(part: str):
    def fn(v: Val) -> list[bytes]:
        dt = convert(v, TypeID.DATETIME).value
        out = struct.pack(">h", dt.year)
        if part in ("month", "day", "hour"):
            out += bytes([dt.month])
        if part in ("day", "hour"):
            out += bytes([dt.day])
        if part == "hour":
            out += bytes([dt.hour])
        return [out]

    return fn


# ---------------------------------------------------------------------------
# String tokenizers
# ---------------------------------------------------------------------------

def _normalize(s: str) -> str:
    import unicodedata

    s = unicodedata.normalize("NFKD", s)
    return "".join(c for c in s if not unicodedata.combining(c)).lower()


def _term_tokens(v: Val) -> list[bytes]:
    words = "".join(c if c.isalnum() else " " for c in _normalize(str(v.value))).split()
    return sorted({w.encode("utf-8") for w in words})


def _exact_tokens(v: Val) -> list[bytes]:
    return [str(v.value).encode("utf-8")]


def _hash_tokens(v: Val) -> list[bytes]:
    import hashlib

    return [hashlib.blake2b(str(v.value).encode("utf-8"), digest_size=8).digest()]


def _trigram_tokens(v: Val) -> list[bytes]:
    s = str(v.value)
    return sorted({s[i : i + 3].encode("utf-8") for i in range(len(s) - 2)}) if len(s) >= 3 else []


_STOPWORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such that
    the their then there these they this to was will with""".split()
)


def _is_cons(w: str, i: int) -> bool:
    c = w[i]
    if c in "aeiou":
        return False
    if c == "y":
        return i == 0 or not _is_cons(w, i - 1)
    return True


def _measure(w: str) -> int:
    """Porter's m: number of VC sequences."""
    m, i, n = 0, 0, len(w)
    while i < n and _is_cons(w, i):
        i += 1
    while i < n:
        while i < n and not _is_cons(w, i):
            i += 1
        if i >= n:
            break
        m += 1
        while i < n and _is_cons(w, i):
            i += 1
    return m


def _ends_cvc(w: str) -> bool:
    n = len(w)
    if n < 3:
        return False
    return (_is_cons(w, n - 3) and not _is_cons(w, n - 2)
            and _is_cons(w, n - 1) and w[-1] not in "wxy")


def porter_stem(w: str) -> str:
    """Compact Porter stemmer (steps 1a/1b/1c + common suffix strips) —
    enough to make full-text matching insensitive to plurals/verb forms, the
    property the reference gets from Bleve's English stemmer. The 1b cleanup
    (re-add 'e' on short CVC stems, undouble consonants) keeps inflections
    and their base form on the SAME token: hiking/hike → hike, not hik/hike."""
    if len(w) <= 3:
        return w
    for suf, rep in (("sses", "ss"), ("ies", "i"), ("ss", "ss"), ("s", "")):
        if w.endswith(suf):
            w = w[: len(w) - len(suf)] + rep
            break
    matched = ""
    if w.endswith("eed"):                   # Porter 1b: (m>0) EED -> EE
        if _measure(w[:-3]) > 0:
            w = w[:-1]
        return w
    for suf in ("ational", "tional", "ization", "fulness", "ousness", "iveness",
                "biliti", "entli", "ousli", "ing", "edly", "ed", "ly", "ment", "ness"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            w = w[: len(w) - len(suf)]
            matched = suf
            break
    if matched in ("ing", "ed", "edly"):
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1) \
                and w[-1] not in "lsz":
            w = w[:-1]                      # hopping -> hopp -> hop
        elif _measure(w) == 1 and _ends_cvc(w):
            w += "e"                        # hiking -> hik -> hike
    if len(w) > 2 and w.endswith("y") and any(
            not _is_cons(w, i) for i in range(len(w) - 1)):
        w = w[:-1] + "i"                    # pony/ponies both -> poni
    return w


# per-language full-text analysis (reference tok/fts.go: Bleve analyzers
# selected by the value's lang tag). English keeps the Porter stemmer;
# other supported languages use light suffix-stripping stemmers — the
# contract is CONSISTENCY (index and query tokenize identically under the
# same lang), which is what makes alloftext(pred@ru, ...) match inflected
# forms. Unknown languages analyze without stemming or stopwords.

_LANG_STOPWORDS: dict[str, frozenset] = {
    "ru": frozenset("и в во не что он на я с со как а то все она так его но да"
                    " ты к у же вы за бы по ее мне было вот от меня еще нет о"
                    " из ему был него до вас они ни мы этот того потому этого"
                    " какой ей этом мой тем чтобы есть надо ней для их нее уже"
                    " или вам сказал себя под будет при об это кто".split()),
    "de": frozenset("der die das und oder aber ein eine einen einem einer in"
                    " im an am auf aus bei mit nach seit von zu zum zur ist"
                    " sind war waren wird werden nicht auch als wie für den"
                    " des dem es ich du er sie wir ihr man sich".split()),
    "fr": frozenset("le la les un une des du de au aux et ou mais dans par"
                    " pour sur avec sans sous est sont était ce cette ces il"
                    " elle ils elles je tu nous vous se ne pas plus que qui"
                    " quoi dont où".split()),
    "es": frozenset("el la los las un una unos unas y o pero en de del al con"
                    " por para sin sobre es son era eran este esta estos estas"
                    " yo tú él ella nosotros ellos se no sí que quien como".split()),
    "it": frozenset("il lo la i gli le un uno una e o ma in di del della al"
                    " alla con per su da è sono era erano questo questa io tu"
                    " lui lei noi voi loro si non che chi come".split()),
}
# tokens are compared AFTER _normalize (NFKD + strip combining marks +
# lower), so the tables must hold normalized forms — 'était' arrives as
# 'etait', 'für' as 'fur'
_LANG_STOPWORDS = {k: frozenset(_normalize(w) for w in v)
                   for k, v in _LANG_STOPWORDS.items()}

_LANG_SUFFIXES: dict[str, list[str]] = {
    # longest-first light stemmers; endings chosen to fold the common
    # number/case/verb inflections onto one token
    "ru": ["иями", "ями", "ами", "ием", "иях", "иям", "ется",
           "ого", "его", "ому", "ему", "ыми", "ими",
           "ают", "яют", "уют", "юют", "ает", "яет", "ует",
           "ют", "ешь", "ишь", "ить", "ать", "ять", "еть", "ов", "ев",
           "ий", "ый", "ой", "ей", "ом", "ем", "ам", "ям", "ах", "ях",
           "ла", "ло", "ли", "ть", "ы", "и", "а", "я", "о", "е", "у",
           "ю", "ь"],
    "de": ["ungen", "ung", "heit", "keit", "lich", "isch", "ern", "en",
           "er", "es", "em", "e", "n", "s"],
    "fr": ["issements", "issement", "issantes", "issant", "emment",
           "ement", "ments", "ment", "euses", "euse", "eaux", "eux",
           "ives", "ive", "ées", "ée", "és", "é", "er", "es", "e", "s"],
    "es": ["amientos", "amiento", "aciones", "ación", "adores", "ador",
           "ancias", "ancia", "mente", "idades", "idad", "ando", "iendo",
           "arse", "ar", "er", "ir", "as", "os", "es", "a", "o", "e", "s"],
    "it": ["azioni", "azione", "amenti", "amento", "mente", "ando",
           "endo", "are", "ere", "ire", "i", "e", "a", "o"],
}
_LANG_SUFFIXES = {k: [_normalize(s) for s in v]
                  for k, v in _LANG_SUFFIXES.items()}


def lang_stem(w: str, code: str) -> str:
    """Stemmer for a 2-letter language code: Porter for English, light
    suffix stripping for the other supported languages, identity else."""
    if code == "en":
        return porter_stem(w)
    rules = _LANG_SUFFIXES.get(code)
    if rules is None:
        return w
    for suf in rules:
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: len(w) - len(suf)]
    return w


def fulltext_tokens(text: str, lang: str = "") -> list[bytes]:
    """Language-aware full-text terms (unprefixed). The lang tag's primary
    subtag picks the analyzer; untagged text analyzes as English (the
    reference's default analyzer)."""
    code = (lang or "en").split("-")[0].lower()
    stop = _STOPWORDS if code == "en" else _LANG_STOPWORDS.get(
        code, frozenset())
    words = "".join(c if c.isalnum() else " "
                    for c in _normalize(text)).split()
    return sorted({lang_stem(w, code).encode("utf-8")
                   for w in words if w not in stop})


def _fulltext_tokens(v: Val) -> list[bytes]:
    return fulltext_tokens(str(v.value))


def _geo_tokens(v: Val) -> list[bytes]:
    from dgraph_tpu_torch.utils import geo as geomod

    g = v.value if not isinstance(v.value, (str, bytes, dict)) else geomod.parse_geojson(v.value)
    return [t.encode("ascii") for t in geomod.index_tokens(g)]


# ---------------------------------------------------------------------------
# Registry population (idents mirror the reference's 1-byte space,
# tok/tok.go registry :76-133)
# ---------------------------------------------------------------------------

register(Tokenizer("term", 0x01, TypeID.STRING, sortable=False, lossy=True, fn=_term_tokens))
register(Tokenizer("exact", 0x02, TypeID.STRING, sortable=True, lossy=False, fn=_exact_tokens))
register(Tokenizer("year", 0x04, TypeID.DATETIME, sortable=True, lossy=True, fn=_dt_part("year")))
register(Tokenizer("month", 0x41, TypeID.DATETIME, sortable=True, lossy=True, fn=_dt_part("month")))
register(Tokenizer("day", 0x42, TypeID.DATETIME, sortable=True, lossy=True, fn=_dt_part("day")))
register(Tokenizer("hour", 0x43, TypeID.DATETIME, sortable=True, lossy=True, fn=_dt_part("hour")))
register(Tokenizer("geo", 0x05, TypeID.GEO, sortable=False, lossy=True, fn=_geo_tokens))
register(Tokenizer("int", 0x06, TypeID.INT, sortable=True, lossy=False, fn=_int_tokens))
register(Tokenizer("float", 0x07, TypeID.FLOAT, sortable=True, lossy=True, fn=_float_tokens))
register(Tokenizer("fulltext", 0x08, TypeID.STRING, sortable=False, lossy=True, fn=_fulltext_tokens))
register(Tokenizer("bool", 0x09, TypeID.BOOL, sortable=False, lossy=False, fn=_bool_tokens))
register(Tokenizer("trigram", 0x0A, TypeID.STRING, sortable=False, lossy=True, fn=_trigram_tokens))
register(Tokenizer("hash", 0x0B, TypeID.STRING, sortable=False, lossy=True, fn=_hash_tokens))


def register_custom(name: str, fn: Callable[[Val], list[bytes]],
                    type_id: TypeID = TypeID.STRING, sortable: bool = False,
                    lossy: bool = True) -> None:
    """Custom tokenizer (reference: Go plugin LoadCustomTokenizer, tok/tok.go:92).
    Custom idents live in 0x80+ to never collide with built-ins."""
    ident = 0x80 + (sum(name.encode()) % 0x70)
    taken = {t.ident for t in _REGISTRY.values()}
    while ident in taken:
        ident = 0x80 + ((ident + 1 - 0x80) % 0x70)
    register(Tokenizer(name, ident, type_id, sortable, lossy, fn))


def load_custom_module(spec: str) -> None:
    """Load custom tokenizers from 'module.path' exposing TOKENIZERS =
    [(name, fn, type_id, sortable, lossy), ...] — the plugin mechanism."""
    import importlib

    mod = importlib.import_module(spec)
    for name, fn, tid, sortable, lossy in getattr(mod, "TOKENIZERS", []):
        register_custom(name, fn, tid, sortable, lossy)
