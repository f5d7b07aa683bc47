"""Per-commit attribute index: posting lists + numeric zone maps.

Written at check-in next to the manifest (content-addressed), consumed by
:meth:`~repro_torch.core.dataset.CheckoutPlan.iter_entries` via the
``Query.index_plan`` visitor so selective checkouts only deserialize and
evaluate candidate manifest entries instead of scanning every record.

Design
------
- **Positions, not ids.** All structures map to integer positions in the
  manifest's record-id-sorted order — the exact order ``iter_entries``
  streams — so a resolved plan is just "construct these entries".
- **Posting lists** for scalar attributes with at most ``max_cardinality``
  distinct values: canonical value key -> sorted positions.  Numerics
  (``bool``/``int``/``float``) share one canonical class per numeric value
  because Python equality does (``1 == 1.0 == True``); strings and ``None``
  get their own classes.  Posting lists are *complete* for a kept field
  (every present occurrence is listed), which is what makes complements
  (``!=``, ``~``) and absence reasoning exact.
- **Zone maps** for numeric attributes of any cardinality: per block of
  ``zone_block`` consecutive positions, the [min, max] of the numeric
  values present (``None`` for blocks with no numeric value).  Range
  predicates prune to candidate blocks; candidates are re-evaluated, so
  zone answers only need to be supersets.
- Fields never seen in any record are recorded implicitly: the planner
  treats them as "absent everywhere", which is itself exact.

Paged manifests (PR 4) make the index **per page**: every manifest page
gets its own :class:`AttributeIndex` (content-addressed by the page
digest, so unchanged pages never rebuild or rewrite their index), and
:class:`PagedAttributeIndex` presents the per-page indexes as one merged
planner surface — global positions are page offsets plus local positions,
so ``Query.index_plan`` is layout-agnostic and prunes whole pages before
any page blob is deserialized.  The planner consumes zone maps through
:meth:`zone_spans_for` (explicit ``(start, end, min, max)`` spans) so
per-page blocks and the legacy uniform global blocks plan identically.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["AttributeIndex", "PagedAttributeIndex", "page_summary"]

# Attr names shadowed by the query pseudo-field ``id`` — indexing them would
# invite resolving Cmp("id", ...) against the wrong values.
_RESERVED_FIELDS = ("id", "record_id")


def canon_key(value) -> Optional[str]:
    """Canonical posting key for a scalar value; ``None`` if unindexable.

    Numerics collapse to one class per numeric value (``1``/``1.0``/``True``
    all compare equal in Python, so they must share a posting list for
    lookups to stay a correct superset).
    """
    if value is None:
        return "z"
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, int):
        return "n:%d" % value
    if isinstance(value, float):
        if value.is_integer() and abs(value) < 2 ** 53:
            return "n:%d" % int(value)
        return "n:%r" % value
    if isinstance(value, str):
        return "s:" + value
    return None


def decode_key(key: str):
    """Representative value of a posting class (for predicate evaluation)."""
    if key == "z":
        return None
    if key.startswith("s:"):
        return key[2:]
    num = key[2:]
    try:
        return int(num)
    except ValueError:
        return float(num)


class AttributeIndex:
    """Queryable per-commit index over one manifest's attributes."""

    VERSION = 1
    MAX_CARDINALITY = 64
    ZONE_BLOCK = 256

    def __init__(
        self,
        n_records: int,
        fields: Dict[str, dict],
        postings: Dict[str, Dict[str, List[int]]],
        zones: Dict[str, List[Optional[List[float]]]],
        zone_block: int = ZONE_BLOCK,
    ) -> None:
        self.n = n_records
        self.fields = fields
        self.postings = postings
        self.zones = zones
        self.block = zone_block

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, entries, max_cardinality: int = MAX_CARDINALITY,
              zone_block: int = ZONE_BLOCK) -> "AttributeIndex":
        """Index ``entries`` (already in record-id-sorted manifest order)."""
        return cls.build_attrs([entry.attrs for entry in entries],
                               max_cardinality=max_cardinality,
                               zone_block=zone_block)

    @classmethod
    def build_attrs(cls, attrs_seq: Sequence[Optional[dict]],
                    max_cardinality: int = MAX_CARDINALITY,
                    zone_block: int = ZONE_BLOCK) -> "AttributeIndex":
        """Index a manifest-ordered attrs sequence directly.

        The write path indexes raw manifest records here without
        materializing :class:`RecordEntry` objects — only the attrs matter
        to the index.
        """
        n = len(attrs_seq)
        fields: Dict[str, dict] = {}
        postings: Dict[str, Dict[str, List[int]]] = {}
        numerics: Dict[str, List] = {}
        for pos, attrs in enumerate(attrs_seq):
            for f, v in (attrs or {}).items():
                if f in _RESERVED_FIELDS:
                    continue
                info = fields.setdefault(
                    f, {"present": 0, "postings": True, "zones": False})
                info["present"] += 1
                if info["postings"]:
                    key = canon_key(v)
                    pmap = postings.setdefault(f, {})
                    if key is None or (key not in pmap
                                       and len(pmap) >= max_cardinality):
                        # non-scalar value or cardinality blown: a partial
                        # posting list is unsound, drop the whole field
                        info["postings"] = False
                        postings.pop(f, None)
                    else:
                        pmap.setdefault(key, []).append(pos)
                if isinstance(v, bool):
                    v = int(v)
                if isinstance(v, (int, float)) and v == v:  # NaN never
                    info["zones"] = True                    # matches ranges
                    numerics.setdefault(f, []).append((pos, float(v)))
        zones: Dict[str, List[Optional[List[float]]]] = {}
        n_blocks = (n + zone_block - 1) // zone_block
        for f, pairs in numerics.items():
            blocks: List[Optional[List[float]]] = [None] * n_blocks
            for pos, fv in pairs:
                cur = blocks[pos // zone_block]
                if cur is None:
                    blocks[pos // zone_block] = [fv, fv]
                elif fv < cur[0]:
                    cur[0] = fv
                elif fv > cur[1]:
                    cur[1] = fv
            zones[f] = blocks
        return cls(n, fields, postings, zones, zone_block)

    # -- serialization -------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "v": self.VERSION,
            "n": self.n,
            "block": self.block,
            "fields": self.fields,
            "postings": self.postings,
            "zones": self.zones,
        }

    @staticmethod
    def from_json(obj: dict) -> "AttributeIndex":
        return AttributeIndex(
            int(obj["n"]), obj.get("fields", {}), obj.get("postings", {}),
            obj.get("zones", {}), int(obj.get("block", AttributeIndex.ZONE_BLOCK)))

    # -- planner surface (consumed by Query.index_plan) ----------------------

    def postings_for(self, field: str) -> Optional[Dict[str, List[int]]]:
        """Posting lists for ``field``; ``{}`` if the field appears in no
        record (absent everywhere — itself exact); ``None`` if present but
        not postings-indexed (planner must not use postings for it)."""
        info = self.fields.get(field)
        if info is None:
            return {}
        if not info.get("postings"):
            return None
        return self.postings.get(field, {})

    def zones_for(self, field: str) -> Optional[List[Optional[List[float]]]]:
        """Zone blocks for ``field``; ``[]`` if absent everywhere; ``None``
        if the field has no numeric values to zone-map."""
        info = self.fields.get(field)
        if info is None:
            return []
        if not info.get("zones"):
            return None
        return self.zones.get(field, [])

    def zone_spans_for(
        self, field: str
    ) -> Optional[List[Tuple[int, int, float, float]]]:
        """Zone maps as explicit ``(start, end, min, max)`` position spans.

        This is the planner contract (block size stays an encoding
        detail): ``None`` means zones cannot answer for this field, an
        empty list means no position can hold a numeric value for it.
        """
        zones = self.zones_for(field)
        if zones is None:
            return None
        spans: List[Tuple[int, int, float, float]] = []
        for b, mm in enumerate(zones):
            if mm is None:
                continue
            spans.append((b * self.block, min((b + 1) * self.block, self.n),
                          mm[0], mm[1]))
        return spans

    def all_positions(self) -> set:
        return set(range(self.n))

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        """Summary for ``DatasetHandle.index_stats`` / bench output."""
        out = {"n_records": self.n, "zone_block": self.block, "fields": {}}
        for f, info in sorted(self.fields.items()):
            mode = []
            if info.get("postings"):
                mode.append("postings")
            if info.get("zones"):
                mode.append("zones")
            out["fields"][f] = {
                "present": info.get("present", 0),
                "indexed": "+".join(mode) if mode else None,
                "values": len(self.postings.get(f, {}))
                if info.get("postings") else None,
            }
        return out


# ---------------------------------------------------------------------------
# Paged manifests: per-page summaries + the merged planner view
# ---------------------------------------------------------------------------

_SUMMARY_MAX_VALUES = 8


def page_summary(attrs_seq: Sequence[dict]) -> Dict[str, dict]:
    """Tiny per-page attribute summary stored in the page directory.

    Per field: occurrence count, the distinct canonical value keys (capped
    at ``_SUMMARY_MAX_VALUES``, else ``None`` = "too many / unindexable"),
    and the numeric [min, max].  This is the page-granular substrate
    quality tooling reads without touching page blobs, and what
    ``DatasetHandle.page_stats`` surfaces.
    """
    out: Dict[str, dict] = {}
    for attrs in attrs_seq:
        for f, v in (attrs or {}).items():
            if f in _RESERVED_FIELDS:
                continue
            info = out.setdefault(f, {"present": 0, "vals": []})
            info["present"] += 1
            vals = info["vals"]
            if vals is not None:
                key = canon_key(v)
                if key is None:
                    info["vals"] = None
                elif key not in vals:
                    if len(vals) >= _SUMMARY_MAX_VALUES:
                        info["vals"] = None
                    else:
                        vals.append(key)
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, (int, float)) and v == v:
                fv = float(v)
                if "min" not in info or fv < info["min"]:
                    info["min"] = fv
                if "max" not in info or fv > info["max"]:
                    info["max"] = fv
    for info in out.values():
        if info["vals"] is not None:
            info["vals"] = sorted(info["vals"])
    return out


class PagedAttributeIndex:
    """Merged planner view over one per-page :class:`AttributeIndex` each.

    Global position = page offset + local position, so ``Query.index_plan``
    runs unmodified against this class; a page none of whose positions
    survive planning is never deserialized by the checkout path.  Page
    index blobs are fetched lazily (one batched read) and memoized, and
    because they are content-addressed by page digest, unchanged pages
    share their index bytes across every commit that contains them.
    """

    VERSION = 2

    def __init__(self, fetch_jsons: Callable[[List[str]], List[dict]],
                 page_index_digests: Sequence[str],
                 counts: Sequence[int]) -> None:
        self._fetch = fetch_jsons
        self._digests = list(page_index_digests)
        self.offsets: List[int] = []
        total = 0
        for c in counts:
            self.offsets.append(total)
            total += int(c)
        self.n = total
        self._pages: Optional[List[AttributeIndex]] = None
        self._postings_memo: Dict[str, Optional[Dict[str, List[int]]]] = {}

    def _load(self) -> List[AttributeIndex]:
        if self._pages is None:
            self._pages = [AttributeIndex.from_json(doc)
                           for doc in self._fetch(self._digests)]
        return self._pages

    # -- planner surface (same contract as AttributeIndex) -------------------

    def postings_for(self, field: str) -> Optional[Dict[str, List[int]]]:
        if field in self._postings_memo:
            return self._postings_memo[field]
        merged: Dict[str, List[int]] = {}
        seen = False
        for off, page in zip(self.offsets, self._load()):
            pmap = page.postings_for(field)
            if pmap is None:
                # present in this page but not postings-indexed: the merged
                # lists would be incomplete, which is unsound for ne/Not
                self._postings_memo[field] = None
                return None
            if field in page.fields:
                seen = True
            for key, positions in pmap.items():
                merged.setdefault(key, []).extend(off + p for p in positions)
        out = merged if seen else {}
        self._postings_memo[field] = out
        return out

    def zone_spans_for(
        self, field: str
    ) -> Optional[List[Tuple[int, int, float, float]]]:
        # Pages where the field is absent or never numeric contribute no
        # spans — sound, because the planner only consults zones for
        # numeric comparison values, which non-numeric/absent attrs can
        # never satisfy.
        spans: List[Tuple[int, int, float, float]] = []
        for off, page in zip(self.offsets, self._load()):
            s = page.zone_spans_for(field)
            if s:
                spans.extend((off + a, off + b, lo, hi)
                             for a, b, lo, hi in s)
        return spans

    def all_positions(self) -> set:
        return set(range(self.n))

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        out = {"n_records": self.n, "n_pages": len(self._digests),
               "fields": {}}
        fields: Dict[str, dict] = {}
        values: Dict[str, set] = {}
        for page in self._load():
            for f, info in page.fields.items():
                agg = fields.setdefault(
                    f, {"present": 0, "postings": True, "zones": False})
                agg["present"] += info.get("present", 0)
                agg["postings"] = agg["postings"] and bool(
                    info.get("postings"))
                agg["zones"] = agg["zones"] or bool(info.get("zones"))
                if info.get("postings"):
                    values.setdefault(f, set()).update(
                        page.postings.get(f, {}))
        for f, agg in sorted(fields.items()):
            mode = [m for m, on in (("postings", agg["postings"]),
                                    ("zones", agg["zones"])) if on]
            out["fields"][f] = {
                "present": agg["present"],
                "indexed": "+".join(mode) if mode else None,
                "values": len(values.get(f, ())) if agg["postings"] else None,
            }
        return out
