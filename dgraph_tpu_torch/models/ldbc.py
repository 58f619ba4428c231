"""Deterministic LDBC-SNB-interactive-SHAPED synthetic generator.

Copy of dgraph_tpu/models/ldbc.py for the PyTorch port: the same (sf, seed)
writes the same bytes in either package.

Emits the DATAGEN "social_network" CSV layout (pipe-separated, one header
row, `<stem>_0_0.csv` file names) that `convert --ldbc`
(loader/convert.convert_ldbc) already maps to N-Quads + schema — a
stand-in for the official DATAGEN dumps where they are not at hand. LDBC-shaped, not DATAGEN-exact:

  * persons           ≈ 10 000 · SF^0.85 (the sub-linear person curve of
                        the official generator), power-law `knows` degree
                        (discrete Zipf, capped) over a random permutation
                        so uid order carries no structure.
  * posts / comments  per-person activity is itself power-law (a few
                        loud users, a long quiet tail — the fan-out that
                        makes depth-3 replyOf/hasCreator traversals
                        realistic). Comments reply to a post or to an
                        earlier comment (≈45%), forming reply chains.

Determinism contract (tested): same (sf, seed) ⇒ byte-identical CSVs ⇒
identical N-Quads sha256 through convert_ldbc. All randomness flows from
one seeded numpy Generator; no clocks, no dict-order dependence.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class LdbcGenStats:
    sf: float = 0.0
    persons: int = 0
    knows: int = 0
    posts: int = 0
    comments: int = 0
    edges: int = 0          # knows + hasCreator + replyOf relation rows


_FIRST = ["Mahinda", "Carmen", "Jan", "Yang", "Ana", "Otto", "Priya",
          "Kenji", "Lars", "Abebe", "Bryn", "Chen", "Deepa", "Emeka",
          "Farah", "Hồ Chí"]
_LAST = ["Perera", "Lepland", "Zholobov", "Li", "Silva", "Weber",
         "Sharma", "Sato", "Berg", "Bekele", "Jones", "Wang", "Rao",
         "Okafor", "Haddad", "Do"]
_LANGS = ["en", "uz", "vi", "de", "pt", "hi", "ja", "zh"]
_WORDS = ["about", "graph", "mesh", "fold", "tablet", "frontier", "edge",
          "shard", "query", "snapshot", "photo", "friends", "travel",
          "music", "maybe", "exactly", "thanks", "agree"]


def _zipf_degrees(rng: np.random.Generator, n: int, mean: float,
                  cap: int) -> np.ndarray:
    """Discrete power-law degrees with roughly the requested mean: Zipf
    (a=2.2) rescaled and capped — a few hubs, a long tail."""
    if n == 0:
        return np.zeros(0, np.int64)
    raw = rng.zipf(2.2, size=n).astype(np.int64)
    raw = np.minimum(raw, cap)
    scale = mean / max(raw.mean(), 1e-9)
    deg = np.maximum(0, np.round(raw * scale)).astype(np.int64)
    return np.minimum(deg, cap)


def _date(rng: np.random.Generator, n: int) -> list[str]:
    """Deterministic creationDate column (2010, DATAGEN-styled)."""
    day = rng.integers(1, 359, size=n)
    sec = rng.integers(0, 86400, size=n)
    out = []
    for d, s in zip(day.tolist(), sec.tolist()):
        mo, dd = 1 + d // 30, 1 + d % 30
        out.append(f"2010-{mo:02d}-{dd:02d}T{s // 3600:02d}:"
                   f"{(s // 60) % 60:02d}:{s % 60:02d}.000+0000")
    return out


def generate_ldbc(out_dir: str, sf: float = 0.1,
                  seed: int = 20260804) -> LdbcGenStats:
    """Write an LDBC-shaped CSV dump for scale factor `sf` under
    `out_dir` (created if needed). Returns the generation stats."""
    rng = np.random.default_rng([int(seed), int(round(sf * 1_000_000))])
    os.makedirs(out_dir, exist_ok=True)
    st = LdbcGenStats(sf=float(sf))

    n_person = max(40, int(round(10_000 * sf ** 0.85)))
    person_ids = (933 + 7 * np.arange(n_person)).astype(np.int64)
    st.persons = n_person

    # -- person entities ------------------------------------------------------
    fi = rng.integers(0, len(_FIRST), size=n_person)
    la = rng.integers(0, len(_LAST), size=n_person)
    ge = rng.integers(0, 2, size=n_person)
    by = rng.integers(1950, 2000, size=n_person)
    bm = rng.integers(1, 13, size=n_person)
    bd = rng.integers(1, 29, size=n_person)
    dates = _date(rng, n_person)
    with open(os.path.join(out_dir, "person_0_0.csv"), "w",
              encoding="utf-8") as f:
        f.write("id|firstName|lastName|gender|birthday|creationDate|"
                "locationIP|browserUsed\n")
        for i in range(n_person):
            f.write(f"{person_ids[i]}|{_FIRST[fi[i]]}|{_LAST[la[i]]}|"
                    f"{'male' if ge[i] else 'female'}|"
                    f"{by[i]}-{bm[i]:02d}-{bd[i]:02d}|{dates[i]}|"
                    f"10.0.0.{i % 250}|Firefox\n")

    # -- knows (power-law, deduped, no self-loops) ----------------------------
    mean_deg = 18.0 + 4.0 * np.log10(max(sf, 1e-3) + 1.0)
    deg = _zipf_degrees(rng, n_person, mean_deg, cap=max(64, n_person // 4))
    src = np.repeat(np.arange(n_person), deg)
    dst = rng.integers(0, n_person, size=len(src))
    keep = src != dst
    pairs = np.unique(np.stack([src[keep], dst[keep]], axis=1), axis=0)
    st.knows = len(pairs)
    k_dates = _date(rng, len(pairs))
    with open(os.path.join(out_dir, "person_knows_person_0_0.csv"), "w",
              encoding="utf-8") as f:
        f.write("Person.id|Person.id|creationDate\n")
        for j, (a, b) in enumerate(pairs.tolist()):
            f.write(f"{person_ids[a]}|{person_ids[b]}|{k_dates[j]}\n")

    # -- posts (per-person power-law activity) --------------------------------
    pdeg = _zipf_degrees(rng, n_person, 3.0 + 2.0 * min(sf, 1.0),
                         cap=256)
    post_author = np.repeat(np.arange(n_person), pdeg)
    n_post = len(post_author)
    post_ids = (343 + 11 * np.arange(n_post)).astype(np.int64)
    st.posts = n_post
    p_dates = _date(rng, n_post)
    p_lang = rng.integers(0, len(_LANGS), size=max(n_post, 1))
    p_words = rng.integers(0, len(_WORDS), size=(max(n_post, 1), 3))
    p_img = rng.random(max(n_post, 1)) < 0.25
    with open(os.path.join(out_dir, "post_0_0.csv"), "w",
              encoding="utf-8") as f:
        f.write("id|imageFile|creationDate|locationIP|browserUsed|"
                "language|content|length\n")
        for i in range(n_post):
            if p_img[i]:
                img, content, lang = f"photo{post_ids[i]}.jpg", "", ""
            else:
                img = ""
                content = " ".join(_WORDS[w] for w in p_words[i])
                lang = _LANGS[p_lang[i]]
            f.write(f"{post_ids[i]}|{img}|{p_dates[i]}|10.0.0.{i % 250}|"
                    f"Firefox|{lang}|{content}|{len(content)}\n")
    with open(os.path.join(out_dir, "post_hasCreator_person_0_0.csv"),
              "w", encoding="utf-8") as f:
        f.write("Post.id|Person.id\n")
        for i in range(n_post):
            f.write(f"{post_ids[i]}|{person_ids[post_author[i]]}\n")

    # -- comments: reply to a post (55%) or an EARLIER comment (45%) ----------
    cdeg = _zipf_degrees(rng, n_person, 6.0 + 4.0 * min(sf, 1.0),
                         cap=512)
    com_author = np.repeat(np.arange(n_person), cdeg)
    n_com = len(com_author) if n_post else 0
    com_ids = (1012 + 13 * np.arange(n_com)).astype(np.int64)
    st.comments = n_com
    c_dates = _date(rng, max(n_com, 1))
    c_words = rng.integers(0, len(_WORDS), size=(max(n_com, 1), 2))
    to_comment = rng.random(max(n_com, 1)) < 0.45
    tgt_post = rng.integers(0, max(n_post, 1), size=max(n_com, 1))
    # reply chains: target an earlier comment (index < i); the first
    # comment always replies to a post
    tgt_com = (rng.random(max(n_com, 1))
               * np.maximum(np.arange(max(n_com, 1)), 1)).astype(np.int64)
    with open(os.path.join(out_dir, "comment_0_0.csv"), "w",
              encoding="utf-8") as fc, \
         open(os.path.join(out_dir, "comment_replyOf_post_0_0.csv"), "w",
              encoding="utf-8") as fp, \
         open(os.path.join(out_dir, "comment_replyOf_comment_0_0.csv"),
              "w", encoding="utf-8") as fr, \
         open(os.path.join(out_dir, "comment_hasCreator_person_0_0.csv"),
              "w", encoding="utf-8") as fh:
        fc.write("id|creationDate|locationIP|browserUsed|content|length\n")
        fp.write("Comment.id|Post.id\n")
        fr.write("Comment.id|Comment.id\n")
        fh.write("Comment.id|Person.id\n")
        for i in range(n_com):
            content = " ".join(_WORDS[w] for w in c_words[i])
            fc.write(f"{com_ids[i]}|{c_dates[i]}|10.0.0.{i % 250}|"
                     f"Firefox|{content}|{len(content)}\n")
            if to_comment[i] and i > 0:
                fr.write(f"{com_ids[i]}|{com_ids[tgt_com[i]]}\n")
            else:
                fp.write(f"{com_ids[i]}|{post_ids[tgt_post[i]]}\n")
            fh.write(f"{com_ids[i]}|{person_ids[com_author[i]]}\n")

    st.edges = st.knows + n_post + 2 * n_com
    return st
