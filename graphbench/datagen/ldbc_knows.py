"""An LDBC SNB-shaped Person-knows graph (the Datagen's correlated `knows`
edges), on the device.

The LDBC Social Network Benchmark's Datagen gives every Person a target
number of friends from a heavy-tailed degree law, then makes the edges in
passes, each over the Persons sorted by one correlation dimension: most
friends are near a Person in that order, the rest are drawn at random.
This generator follows that shape, with the choices its configuration
states under `assumed`:

- degrees: a discrete power law, x = (1 - u) ** (-1 / (exponent - 1)),
  scaled by the one factor that makes the mean of clamp(floor(s x), 1,
  cap) equal 2 knows / persons; cap is the configuration's, at most
  persons - 1;
- passes: each Person's degree splits over the configuration's passes by
  their shares. In a pass with an order, the Persons take their places in
  a seeded permutation, each of a Person's stubs (one end of an edge to
  be) lands at a two-sided geometric offset of mean `window` x persons
  from its Person's place (around the circle), and the stubs sorted by
  where they landed pair off in turn, so partners lie near each other in
  that order; the uniform pass sorts its stubs by a random key;
- the shortfall: a self-loop is dropped and a repeated pair merged, which
  costs the hubs most. As many edges as are still missing from `knows`
  are then drawn again, each from a Person short of its target degree
  (drawn in proportion to how short, times the share of Persons it does
  not know yet) to a partner that one of the passes draws (a pass in
  proportion to its share): near in its order, at the same geometric
  offset, or uniform. Repeats are merged again, up to ROUNDS times,
  until the distinct edges are within TOLERANCE of `knows`;
- labels: Person i is uid perm[i] + 1 for a seeded permutation, so uids
  are 1..persons;
- storage: each undirected edge {u, v} is emitted both ways, u -> v and
  v -> u, as graph500_undirected.py does.
"""

from __future__ import annotations

import math

import torch

ROUNDS = 16             # at most this many rounds deal out the shortfall
TOLERANCE = 0.002       # stop once the edges are within this share of knows


def mean_degree(persons: int) -> float:
    """The Datagen's mean-degree law n ** (0.512 - 0.028 log10 n) times
    0.89, the ratio the published SF 1, 10 and 100 counts give to it."""
    return 0.89 * persons ** (0.512 - 0.028 * math.log10(persons))


def degrees(n: int, mean: float, exponent: float, cap: int,
            g: torch.Generator, device) -> torch.Tensor:
    """int64[n] target degrees: the scaled, capped discrete power law."""
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    x = (1.0 - u) ** (-1.0 / (exponent - 1.0))

    def law(s: float) -> torch.Tensor:
        return torch.clamp(torch.floor(s * x), 1, cap)

    lo, hi = 0.0, 2.0 * mean
    while float(law(hi).mean()) < mean and hi < 1e9:
        hi *= 2.0
    for _ in range(64):                 # mean(law(s)) grows with s
        mid = 0.5 * (lo + hi)
        if float(law(mid).mean()) < mean:
            lo = mid
        else:
            hi = mid
    return law(hi).to(torch.int64)


def _stubs(share: float, want: torch.Tensor, g, device) -> torch.Tensor:
    """Each Person's stubs in one pass: share x its degree, rounded up
    with the fraction's probability."""
    w = share * want.to(torch.float64)
    frac = torch.rand(w.shape, generator=g, device=device,
                      dtype=torch.float64)
    return torch.floor(w + frac).to(torch.int64)


def _pair(owner: torch.Tensor, key: torch.Tensor):
    """Sort stubs by key and pair them off in turn: (a, b) of each pair."""
    s = owner[torch.argsort(key)]
    m = s.numel() // 2 * 2
    return s[0:m:2], s[1:m:2]


def _near(place, owner, window_geo, g, device):
    """Each stub's landing place: its Person's place in a pass's order
    plus a two-sided geometric offset, around the circle; and the uniform
    draw that chose each offset's sign."""
    n = place.numel()
    u = torch.rand(owner.shape, generator=g, device=device,
                   dtype=torch.float64)
    r = torch.rand(owner.shape, generator=g, device=device,
                   dtype=torch.float64)
    off = torch.floor(torch.log1p(-u) / window_geo)
    sign = torch.where(r < 0.5, -1.0, 1.0)
    return torch.remainder(place[owner].to(torch.float64) + sign * off, n), r


def generate(cfg: dict, seed: int, device) -> dict:
    n, knows = int(cfg["persons"]), int(cfg["knows"])
    cap = min(int(cfg["degree_cap"]), n - 1)
    window = float(cfg["window"]) * n
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    target = degrees(n, 2.0 * knows / n, float(cfg["degree_exponent"]), cap,
                     g, device)
    geo = math.log1p(-1.0 / (window + 1.0))      # Geometric, mean `window`
    # each ordered pass: the Persons' places in its seeded order, and who
    # stands at each place
    passes = []
    for p in cfg["passes"]:
        place = torch.randperm(n, generator=g, device=device) \
            if p["order"] else None
        inv = torch.argsort(place) if p["order"] else None
        passes.append((float(p["share"]), place, inv))
    ids = torch.arange(n, device=device)
    # round 0: every stub of every Person, paired off in each pass
    pa, pb = [], []
    for share, place, inv in passes:
        owner = torch.repeat_interleave(ids, _stubs(share, target, g, device))
        if place is None:
            key = torch.rand(owner.shape, generator=g, device=device,
                             dtype=torch.float64)
        else:
            land, r = _near(place, owner, geo, g, device)
            # frac(2 r), uniform whatever the sign, breaks ties at random
            key = land + torch.frac(2.0 * r)
        a, b = _pair(owner, key)
        pa.append(a)
        pb.append(b)
    edges = _merge(torch.zeros(0, dtype=torch.int64, device=device),
                   torch.cat(pa), torch.cat(pb), n)
    # the shortfall that merged repeats left (mostly the hubs'): as many
    # edges as are missing, each from a Person short of its degree, drawn
    # in proportion to how short and to the share of Persons it does not
    # know yet, to a partner the passes draw: near in the pass's order, or
    # uniform
    shares = torch.tensor([s for s, _, _ in passes], dtype=torch.float64,
                          device=device)
    for _ in range(ROUNDS):
        missing = knows - edges.numel()
        if missing <= TOLERANCE * knows:
            break
        got = torch.bincount(edges // n, minlength=n) + torch.bincount(
            edges % n, minlength=n)
        short = torch.clamp(target - got, min=0).to(torch.float64) * (
            (n - 1 - got).to(torch.float64) / (n - 1))
        if float(short.sum()) <= 0:
            break
        owner = torch.multinomial(short, missing, replacement=True,
                                  generator=g)
        which = torch.multinomial(shares, missing, replacement=True,
                                  generator=g)
        partner = torch.randint(0, n, owner.shape, generator=g,
                                device=device)
        for i, (_, place, inv) in enumerate(passes):
            if place is None:
                continue
            land, _ = _near(place, owner, geo, g, device)
            partner = torch.where(which == i, inv[land.to(torch.int64)],
                                  partner)
        edges = _merge(edges, owner, partner, n)
    perm = torch.randperm(n, generator=g, device=device) + 1
    u, v = perm[edges // n], perm[edges % n]
    del edges
    key = torch.unique(torch.cat([(u << 32) | v, (v << 32) | u]))
    attr = cfg["predicate"]
    return {"n": n, "schema": cfg["schema"],
            "edges": {attr: (key >> 32, key & 0xFFFFFFFF)}, "values": {}}


def _merge(edges: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           n: int) -> torch.Tensor:
    """The sorted distinct undirected edges lo * n + hi of `edges` and the
    pairs (a, b), self-loops dropped and repeats merged."""
    keep = a != b
    lo = torch.minimum(a, b)[keep]
    hi = torch.maximum(a, b)[keep]
    return torch.unique(torch.cat([edges, lo * n + hi]))
