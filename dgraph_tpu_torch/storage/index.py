"""Index terms of a value.

Port of index_tokens from dgraph_tpu/storage/index.py (reference
posting/index.go:44 indexTokens). Index maintenance under mutations waits
for the storage slice; storage/csr_build.build_value_pred folds the token
indexes of a committed state from these terms.
"""

from __future__ import annotations

from dgraph_tpu_torch.utils import tok
from dgraph_tpu_torch.utils.schema import SchemaEntry
from dgraph_tpu_torch.utils.types import Val, convert


def index_tokens(entry: SchemaEntry, v: Val, lang: str = "") -> list[bytes]:
    """All index terms for a value under a predicate's tokenizers, each with
    its tokenizer's 1-byte ident prefix. The lang tag selects the full-text
    analyzer (tok/fts.go) — index and query must agree."""
    out: list[bytes] = []
    for name in entry.tokenizers:
        tz = tok.get(name)
        if name == "fulltext" and lang:
            out.extend(bytes([tz.ident]) + t
                       for t in tok.fulltext_tokens(str(v.value), lang))
            continue
        sv = convert(v, tz.type_id) if v.tid != tz.type_id else v
        out.extend(tz.tokens(sv))
    return out
