"""Geo values: GeoJSON parse, geohash covers, spatial predicates.

Copy of dgraph_tpu/utils/geo.py (pure Python) for the PyTorch port.

Reference semantics: types/geo.go (go-geom GeoJSON values), types/s2index.go
(S2 cell covers as index tokens, ~6 levels), types/geofilter.go (near / within
/ contains / intersects query filters with index-cover candidate generation +
exact post-filter).

Redesign: covers use standard geohash cells (base-32, precision 1-9) instead
of S2. The contract is identical — a *lossy* cell→uid index generates
candidates and an exact host-side geometry test post-filters them (the
reference does the same: worker/task.go:921 filterGeoFunction) — only the cell
decomposition differs. Geometry math is self-contained (haversine,
point-in-polygon winding) so no external geo deps are needed.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Iterable

EARTH_RADIUS_M = 6_371_000.0
_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"

# Index precisions: ~5000km .. ~150m cells (analog of the reference's S2
# min/max level loop in types/s2index.go indexCells). Precision 1 has only 32
# cells globally, so a bbox cover always succeeds at some precision >= 1 and
# query covers never silently drop candidate cells.
MIN_PRECISION = 1
MAX_PRECISION = 6


@dataclass(frozen=True)
class Geom:
    """A geometry: kind in {Point, Polygon, MultiPolygon}; coords per GeoJSON."""

    kind: str
    coords: tuple

    def points(self) -> Iterable[tuple[float, float]]:
        if self.kind == "Point":
            yield self.coords
        elif self.kind == "Polygon":
            for ring in self.coords:
                yield from ring
        elif self.kind == "MultiPolygon":
            for poly in self.coords:
                for ring in poly:
                    yield from ring


def _to_tuple(x):
    return tuple(_to_tuple(i) for i in x) if isinstance(x, (list, tuple)) else float(x)


def parse_geojson(s) -> Geom:
    obj = json.loads(s) if isinstance(s, (str, bytes)) else s
    kind = obj.get("type")
    if kind not in ("Point", "Polygon", "MultiPolygon"):
        raise ValueError(f"unsupported geometry type {kind!r}")
    return Geom(kind, _to_tuple(obj["coordinates"]))


def to_geojson(g: Geom) -> str:
    def unroll(x):
        return [unroll(i) for i in x] if isinstance(x, tuple) else x

    return json.dumps({"type": g.kind, "coordinates": unroll(g.coords)})


# ---------------------------------------------------------------------------
# Geohash
# ---------------------------------------------------------------------------

def geohash(lng: float, lat: float, precision: int) -> str:
    lat_rng, lng_rng = [-90.0, 90.0], [-180.0, 180.0]
    bits, even, ch, out = 0, True, 0, []
    while len(out) < precision:
        rng, v = (lng_rng, lng) if even else (lat_rng, lat)
        mid = (rng[0] + rng[1]) / 2
        ch <<= 1
        if v >= mid:
            ch |= 1
            rng[0] = mid
        else:
            rng[1] = mid
        even = not even
        bits += 1
        if bits == 5:
            out.append(_BASE32[ch])
            bits, ch = 0, 0
    return "".join(out)


def geohash_bounds(h: str) -> tuple[float, float, float, float]:
    """(min_lng, min_lat, max_lng, max_lat) of a geohash cell."""
    lat_rng, lng_rng = [-90.0, 90.0], [-180.0, 180.0]
    even = True
    for c in h:
        cd = _BASE32.index(c)
        for shift in range(4, -1, -1):
            rng = lng_rng if even else lat_rng
            mid = (rng[0] + rng[1]) / 2
            if (cd >> shift) & 1:
                rng[0] = mid
            else:
                rng[1] = mid
            even = not even
    return lng_rng[0], lat_rng[0], lng_rng[1], lat_rng[1]


def _cells_covering_bbox(min_lng, min_lat, max_lng, max_lat, precision: int, limit=64):
    """Geohash cells at `precision` overlapping a bbox (grid walk)."""
    cells: list[str] = []
    h0 = geohash(min_lng, min_lat, precision)
    lng0, lat0, lng1, lat1 = geohash_bounds(h0)
    dlng, dlat = lng1 - lng0, lat1 - lat0
    lat = lat0
    while lat < max_lat + dlat / 2:
        lng = lng0
        while lng < max_lng + dlng / 2:
            cells.append(geohash(min(max(lng, -180 + 1e-9), 180 - 1e-9),
                                 min(max(lat, -90 + 1e-9), 90 - 1e-9), precision))
            if len(cells) > limit:
                return None  # too many cells at this precision
            lng += dlng
        lat += dlat
    return sorted(set(cells))


def index_tokens(g: Geom) -> list[str]:
    """Cover tokens written to the geo index for a stored geometry.

    A point is indexed at every precision (so queries at any scale hit it);
    a polygon is indexed by its bbox cover at the coarsest precision that
    keeps the cover small.
    """
    if g.kind == "Point":
        lng, lat = g.coords
        return [geohash(lng, lat, p) for p in range(MIN_PRECISION, MAX_PRECISION + 1)]
    pts = list(g.points())
    lngs = [p[0] for p in pts]
    lats = [p[1] for p in pts]
    toks: list[str] = []
    for p in range(MAX_PRECISION, MIN_PRECISION - 1, -1):
        cover = _cells_covering_bbox(min(lngs), min(lats), max(lngs), max(lats), p)
        if cover is not None:
            # index the cover cells AND their coarser prefixes' points queries
            toks = cover
            break
    else:
        toks = [geohash(lngs[0], lats[0], MIN_PRECISION)]
    # also index coarser ancestors so coarse query covers match
    anc = {t[:p] for t in toks for p in range(MIN_PRECISION, len(t))}
    return sorted(set(toks) | anc)


def query_tokens(g: Geom, radius_m: float | None = None) -> list[str]:
    """Cover tokens probed by a geo query (near/within/intersects candidates)."""
    if g.kind == "Point" and radius_m is not None:
        lng, lat = g.coords
        dlat = math.degrees(radius_m / EARTH_RADIUS_M)
        dlng = dlat / max(math.cos(math.radians(lat)), 1e-6)
        for p in range(MAX_PRECISION, 0, -1):
            cover = _cells_covering_bbox(lng - dlng, lat - dlat, lng + dlng, lat + dlat, p)
            if cover is not None:
                return cover
        return _ALL_P1_CELLS
    if g.kind == "Point":
        lng, lat = g.coords
        return [geohash(lng, lat, p) for p in range(MIN_PRECISION, MAX_PRECISION + 1)]
    pts = list(g.points())
    lngs = [p[0] for p in pts]
    lats = [p[1] for p in pts]
    for p in range(MAX_PRECISION, 0, -1):
        cover = _cells_covering_bbox(min(lngs), min(lats), max(lngs), max(lats), p)
        if cover is not None:
            return cover
    return _ALL_P1_CELLS


# every precision-1 cell (worst-case query cover: whole-globe candidates)
_ALL_P1_CELLS = sorted(_BASE32)


# ---------------------------------------------------------------------------
# Exact predicates (post-filters; reference types/geofilter.go)
# ---------------------------------------------------------------------------

def haversine_m(a: tuple[float, float], b: tuple[float, float]) -> float:
    lng1, lat1, lng2, lat2 = map(math.radians, (*a, *b))
    dlat, dlng = lat2 - lat1, lng2 - lng1
    h = math.sin(dlat / 2) ** 2 + math.cos(lat1) * math.cos(lat2) * math.sin(dlng / 2) ** 2
    return 2 * EARTH_RADIUS_M * math.asin(math.sqrt(h))


def _point_in_ring(pt, ring) -> bool:
    x, y = pt
    inside = False
    for i in range(len(ring) - 1):
        x1, y1 = ring[i][:2]
        x2, y2 = ring[i + 1][:2]
        if (y1 > y) != (y2 > y) and x < (x2 - x1) * (y - y1) / (y2 - y1) + x1:
            inside = not inside
    return inside


def _point_in_polygon(pt, poly) -> bool:
    if not poly or not _point_in_ring(pt, poly[0]):
        return False
    return not any(_point_in_ring(pt, hole) for hole in poly[1:])


def contains(g: Geom, pt: Geom) -> bool:
    """Polygon g contains point pt."""
    if pt.kind != "Point":
        pt = Geom("Point", next(iter(pt.points())))
    if g.kind == "Polygon":
        return _point_in_polygon(pt.coords, g.coords)
    if g.kind == "MultiPolygon":
        return any(_point_in_polygon(pt.coords, poly) for poly in g.coords)
    return g.kind == "Point" and g.coords == pt.coords


def within(g: Geom, region: Geom) -> bool:
    """Geometry g lies within region (vertex containment, as the reference's
    Loop.Contains over loop vertices)."""
    return all(contains(region, Geom("Point", p)) for p in g.points())


def near(g: Geom, center: tuple[float, float], radius_m: float) -> bool:
    return any(haversine_m(p, center) <= radius_m for p in g.points())


def intersects(a: Geom, b: Geom) -> bool:
    if a.kind == "Point":
        return contains(b, a) if b.kind != "Point" else a.coords == b.coords
    if b.kind == "Point":
        return contains(a, b)
    # polygon-polygon: any vertex containment either way (candidate-level test)
    return any(contains(a, Geom("Point", p)) for p in b.points()) or any(
        contains(b, Geom("Point", p)) for p in a.points()
    )
