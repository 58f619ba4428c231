"""Synthetic film/person graph — the goldendata-style benchmark dataset
(reference: contrib/scripts/load-test.sh loads a 1.1M-edge film graph;
this generator produces the same shape at a chosen scale for the BASELINE
config 2-5 query battery). Copy of dgraph_tpu/models/film.py for the
PyTorch port."""

from __future__ import annotations

import numpy as np

GENRES = ["drama", "comedy", "noir", "scifi"]


def film_node(n_people: int = 20000, follows: int = 12, seed: int = 2,
              device: str = "cuda"):
    """An embedded Node on `device` loaded with n_people people, ages,
    genres, and n_people*follows random follow edges."""
    from dgraph_tpu_torch.api.server import Node

    node = Node(device=device)
    node.alter(schema_text="name: string @index(exact) .\n"
                           "age: int @index(int) .\n"
                           "genre: string @index(exact) .\n"
                           "follows: [uid] .")
    rng = np.random.default_rng(seed)
    quads = []
    for i in range(n_people):
        quads.append(f'<0x{i + 1:x}> <name> "p{i}" .')
        quads.append(f'<0x{i + 1:x}> <age> "{18 + i % 60}"^^<xs:int> .')
        quads.append(f'<0x{i + 1:x}> <genre> "{GENRES[i % 4]}" .')
    src = rng.integers(1, n_people + 1, n_people * follows)
    dst = rng.integers(1, n_people + 1, n_people * follows)
    for s, d in zip(src.tolist(), dst.tolist()):
        quads.append(f"<0x{s:x}> <follows> <0x{d:x}> .")
    for lo in range(0, len(quads), 50000):
        node.mutate(set_nquads="\n".join(quads[lo: lo + 50000]),
                    commit_now=True)
    return node
