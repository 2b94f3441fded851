"""Geohash and shape geometry for the geo query family (a whole copy of the
JAX package's `common/geo.py`).

Geohash encode, decode, cell bounds and neighbours serve the `geohash_cell`
filter, the `geohash_grid` aggregation and a `geo_point` given as a geohash.
Shapes are stored per document as canonical JSON in the string doc values
and their relations (`shapes_intersect`, `shape_within`) are exact
computational geometry on the host, so there is no precision knob:
`normalize_shape` turns a GeoJSON-like spec (a point, an envelope or a
polygon with holes) into the (kind, data) pair both the mapper and the
`geo_shape` filter hold. `haversine_m` is the scalar
great-circle distance in metres; the vectorized one the filters, sort,
decay and aggregations use is `search/filters.py haversine_m`.
"""

from __future__ import annotations

import math

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_BASE32_IDX = {c: i for i, c in enumerate(_BASE32)}


def geohash_encode(lat: float, lon: float, precision: int = 12) -> str:
    """Standard geohash: interleaved lon/lat bisection bits, base32."""
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    bits = []
    even = True
    while len(bits) < precision * 5:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon >= mid:
                bits.append(1)
                lon_lo = mid
            else:
                bits.append(0)
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                bits.append(1)
                lat_lo = mid
            else:
                bits.append(0)
                lat_hi = mid
        even = not even
    out = []
    for i in range(0, len(bits), 5):
        v = 0
        for b in bits[i: i + 5]:
            v = (v << 1) | b
        out.append(_BASE32[v])
    return "".join(out)


def geohash_bbox(h: str) -> tuple[float, float, float, float]:
    """(lat_lo, lat_hi, lon_lo, lon_hi) of the cell."""
    if not h:
        raise ValueError("empty geohash")
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    even = True
    for c in h:
        v = _BASE32_IDX[c]
        for shift in range(4, -1, -1):
            bit = (v >> shift) & 1
            if even:
                mid = (lon_lo + lon_hi) / 2
                if bit:
                    lon_lo = mid
                else:
                    lon_hi = mid
            else:
                mid = (lat_lo + lat_hi) / 2
                if bit:
                    lat_lo = mid
                else:
                    lat_hi = mid
            even = not even
    return lat_lo, lat_hi, lon_lo, lon_hi


def geohash_decode(h: str) -> tuple[float, float]:
    """Cell-center (lat, lon)."""
    lat_lo, lat_hi, lon_lo, lon_hi = geohash_bbox(h)
    return (lat_lo + lat_hi) / 2, (lon_lo + lon_hi) / 2


def geohash_neighbors(h: str) -> list[str]:
    """The 8 surrounding cells at the same precision (dateline-wrapped)."""
    lat_lo, lat_hi, lon_lo, lon_hi = geohash_bbox(h)
    dlat = lat_hi - lat_lo
    dlon = lon_hi - lon_lo
    clat, clon = (lat_lo + lat_hi) / 2, (lon_lo + lon_hi) / 2
    out = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            lat = clat + dy * dlat
            lon = clon + dx * dlon
            if not -90.0 <= lat <= 90.0:
                continue
            if lon > 180.0:
                lon -= 360.0
            elif lon < -180.0:
                lon += 360.0
            out.append(geohash_encode(lat, lon, len(h)))
    return sorted(set(out))


# ---------------------------------------------------------------------------
# shapes: normalized form + relations
# ---------------------------------------------------------------------------
# normalized: ("point", (lon, lat))
#             ("envelope", (min_lon, min_lat, max_lon, max_lat))
#             ("polygon", [outer_ring, hole_ring...])  rings = [(lon, lat), ...]


def normalize_shape(spec: dict):
    """GeoJSON-ish {"type", "coordinates"} (ES envelope convention: upper-left,
    lower-right) → normalized tuple. Raises ValueError on unsupported types."""
    t = str(spec.get("type", "")).lower()
    coords = spec.get("coordinates")
    if coords is None:
        raise ValueError("shape requires [coordinates]")
    if t == "point":
        lon, lat = float(coords[0]), float(coords[1])
        return ("point", (lon, lat))
    if t == "envelope":
        (lon1, lat1), (lon2, lat2) = coords  # upper-left, lower-right (ES order)
        return ("envelope", (min(lon1, lon2), min(lat1, lat2),
                             max(lon1, lon2), max(lat1, lat2)))
    if t == "polygon":
        rings = []
        for ring in coords:
            pts = [(float(lon), float(lat)) for lon, lat in ring]
            if len(pts) >= 2 and pts[0] == pts[-1]:
                pts = pts[:-1]  # drop closing point
            if len(pts) < 3:
                raise ValueError("polygon ring needs >= 3 points")
            rings.append(pts)
        if not rings:
            raise ValueError("polygon requires at least the outer ring")
        return ("polygon", rings)
    raise ValueError(f"unsupported geo_shape type [{t}]")


def shape_bbox(shape):
    kind, data = shape
    if kind == "point":
        lon, lat = data
        return (lon, lat, lon, lat)
    if kind == "envelope":
        return data
    lons = [p[0] for p in data[0]]
    lats = [p[1] for p in data[0]]
    return (min(lons), min(lats), max(lons), max(lats))


def _bbox_overlap(a, b):
    return not (a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1])


def _pt_in_ring(pt, ring) -> bool:
    """Ray cast; boundary points count as inside (matches the closed-region
    semantics of the reference's spatial intersects)."""
    x, y = pt
    inside = False
    n = len(ring)
    for i in range(n):
        x1, y1 = ring[i]
        x2, y2 = ring[(i + 1) % n]
        # on-segment check
        if (min(x1, x2) - 1e-12 <= x <= max(x1, x2) + 1e-12
                and min(y1, y2) - 1e-12 <= y <= max(y1, y2) + 1e-12):
            cross = (x2 - x1) * (y - y1) - (y2 - y1) * (x - x1)
            if abs(cross) < 1e-12:
                return True
        if (y1 > y) != (y2 > y):
            xin = (x2 - x1) * (y - y1) / (y2 - y1) + x1
            if x < xin:
                inside = not inside
    return inside


def _pt_in_poly(pt, rings) -> bool:
    if not _pt_in_ring(pt, rings[0]):
        return False
    return not any(_pt_in_ring(pt, hole) for hole in rings[1:])


def _segs_intersect(p1, p2, p3, p4) -> bool:
    def orient(a, b, c):
        v = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        return 0 if abs(v) < 1e-12 else (1 if v > 0 else -1)

    def on_seg(a, b, c):
        return (min(a[0], b[0]) - 1e-12 <= c[0] <= max(a[0], b[0]) + 1e-12
                and min(a[1], b[1]) - 1e-12 <= c[1] <= max(a[1], b[1]) + 1e-12)

    o1, o2 = orient(p1, p2, p3), orient(p1, p2, p4)
    o3, o4 = orient(p3, p4, p1), orient(p3, p4, p2)
    if o1 != o2 and o3 != o4:
        return True
    return ((o1 == 0 and on_seg(p1, p2, p3)) or (o2 == 0 and on_seg(p1, p2, p4))
            or (o3 == 0 and on_seg(p3, p4, p1)) or (o4 == 0 and on_seg(p3, p4, p2)))


def _env_ring(env):
    lo_lon, lo_lat, hi_lon, hi_lat = env
    return [(lo_lon, lo_lat), (hi_lon, lo_lat), (hi_lon, hi_lat), (lo_lon, hi_lat)]


def _ring_edges(ring):
    n = len(ring)
    return [(ring[i], ring[(i + 1) % n]) for i in range(n)]


def shapes_intersect(a, b) -> bool:
    """Exact intersects relation over {point, envelope, polygon}."""
    if not _bbox_overlap(shape_bbox(a), shape_bbox(b)):
        return False
    ka, kb = a[0], b[0]
    if ka == "point" and kb == "point":
        return (abs(a[1][0] - b[1][0]) < 1e-9) and (abs(a[1][1] - b[1][1]) < 1e-9)
    if ka == "point":
        return _shape_contains_pt(b, a[1])
    if kb == "point":
        return _shape_contains_pt(a, b[1])
    ring_a = _env_ring(a[1]) if ka == "envelope" else a[1][0]
    ring_b = _env_ring(b[1]) if kb == "envelope" else b[1][0]
    rings_a = [ring_a] if ka == "envelope" else a[1]
    rings_b = [ring_b] if kb == "envelope" else b[1]
    # any vertex containment either way, else any edge crossing
    if any(_pt_in_poly(p, rings_b) for p in ring_a):
        return True
    if any(_pt_in_poly(p, rings_a) for p in ring_b):
        return True
    return any(_segs_intersect(e1[0], e1[1], e2[0], e2[1])
               for e1 in _ring_edges(ring_a) for e2 in _ring_edges(ring_b))


def _shape_contains_pt(shape, pt) -> bool:
    kind, data = shape
    if kind == "point":
        return (abs(data[0] - pt[0]) < 1e-9) and (abs(data[1] - pt[1]) < 1e-9)
    if kind == "envelope":
        return data[0] - 1e-12 <= pt[0] <= data[2] + 1e-12 \
            and data[1] - 1e-12 <= pt[1] <= data[3] + 1e-12
    return _pt_in_poly(pt, data)


def shape_within(inner, outer) -> bool:
    """inner entirely within outer: every inner vertex inside (holes respected),
    no inner edge crossing ANY outer ring (boundary or hole), and no outer hole
    swallowed by inner (a hole inside inner means inner spans excluded area)."""
    ki = inner[0]
    if ki == "point":
        return _shape_contains_pt(outer, inner[1])
    ring_i = _env_ring(inner[1]) if ki == "envelope" else inner[1][0]
    ko = outer[0]
    if ko == "point":
        return False
    rings_o = [_env_ring(outer[1])] if ko == "envelope" else outer[1]
    if not all(_pt_in_poly(p, rings_o) for p in ring_i):
        return False
    for ring_o in rings_o:
        if any(_segs_intersect(e1[0], e1[1], e2[0], e2[1])
               for e1 in _ring_edges(ring_i) for e2 in _ring_edges(ring_o)
               if e1[0] not in (e2[0], e2[1]) and e1[1] not in (e2[0], e2[1])):
            return False
    return not any(_pt_in_ring(p, ring_i) for hole in rings_o[1:] for p in hole)


def haversine_m(lat1, lon1, lat2, lon2):
    """Great-circle metres (scalar)."""
    r = 6371000.0
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = p2 - p1
    dl = math.radians(lon2 - lon1)
    h = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * r * math.asin(math.sqrt(h))
