"""Declarative, serializable query algebra for checkout.

The paper's "Users or workflows can checkout data by specifying query
conditions" needs queries that are *values*, not opaque Python callables:
a query that can be serialized can be logged, diffed, shipped from a CLI
string, evaluated remotely, and — crucially — **fingerprinted**, so two
identical checkouts resolve to the same cached snapshot instead of minting
a new one per call.

Building queries
----------------
>>> q = (attr("lang") == "en") & ~(attr("split") == "test")
>>> q = attr("score") >= 0.5
>>> q = attr("lang").isin("en", "fr") | tag_in("golden", "clean")

Every query:

- evaluates against a :class:`~repro_torch.core.versioning.RecordEntry`
  (``q(entry) -> bool``),
- round-trips through JSON (``Query.from_json(q.to_json()) == q``),
- has a deterministic ``fingerprint()`` that is stable across processes
  and invariant under ``&``/``|`` argument order,
- parses from a CLI string: ``parse_where("lang=en & split!=test")``.

Grammar for :func:`parse_where` (precedence ``~`` > ``&`` > ``|``)::

    expr   := term ('|' term)*
    term   := factor ('&' factor)*
    factor := '~' factor | '(' expr ')' | cmp
    cmp    := FIELD op VALUE | FIELD 'in' '[' VALUE (',' VALUE)* ']' | FIELD
    op     := '=' '==' '!=' '<' '<=' '>' '>=' '~='   (~= is glob match)

A bare FIELD asserts attribute existence.  Unquoted values are coerced:
``int`` / ``float`` / ``true`` / ``false`` / ``null``; quote to force a
string.  The pseudo-field ``id`` matches the record id.
"""

from __future__ import annotations

import fnmatch
import hashlib
import json
import re
from typing import Callable, List, Optional, Sequence, Tuple

from .index import decode_key as _index_decode_key

__all__ = [
    "Query",
    "TrueQuery",
    "Cmp",
    "And",
    "Or",
    "Not",
    "Opaque",
    "attr",
    "tag_in",
    "record_id_in",
    "ALL",
    "parse_where",
    "as_query",
    "QueryParseError",
]


# ---------------------------------------------------------------------------
# Core expression nodes
# ---------------------------------------------------------------------------


class Query:
    """Base class: a serializable predicate over record entries."""

    # -- composition ---------------------------------------------------------

    def __and__(self, other: "Query") -> "Query":
        if not isinstance(other, Query):
            return NotImplemented
        if isinstance(other, TrueQuery):
            return self
        return And(_flatten(And, (self, other)))

    def __or__(self, other: "Query") -> "Query":
        if not isinstance(other, Query):
            return NotImplemented
        if isinstance(other, TrueQuery):
            return other
        return Or(_flatten(Or, (self, other)))

    def __invert__(self) -> "Query":
        if isinstance(self, Not):
            return self.arg
        return Not(self)

    # -- evaluation ----------------------------------------------------------

    def __call__(self, entry) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    # -- serialization -------------------------------------------------------

    @property
    def serializable(self) -> bool:
        return True

    def to_json(self) -> dict:  # pragma: no cover - abstract
        raise NotImplementedError

    @staticmethod
    def from_json(obj: Optional[dict]) -> "Query":
        if obj is None:
            return ALL
        op = obj.get("op")
        if op == "true":
            return ALL
        if op == "cmp":
            return Cmp(obj["field"], obj["cmp"], obj.get("value"))
        if op == "and":
            return And([Query.from_json(a) for a in obj["args"]])
        if op == "or":
            return Or([Query.from_json(a) for a in obj["args"]])
        if op == "not":
            return Not(Query.from_json(obj["arg"]))
        raise ValueError(f"unknown query op {op!r}")

    def canonical(self) -> dict:
        """Normalized JSON: n-ary ops flattened, args sorted — so logically
        identical compositions fingerprint identically."""
        return self.to_json()

    # -- index resolution ----------------------------------------------------

    def index_plan(self, index) -> Optional[Tuple[set, bool]]:
        """Resolve this query against a per-commit
        :class:`~repro_torch.core.index.AttributeIndex`.

        Returns ``(positions, exact)`` where ``positions`` is a **superset**
        of the matching manifest positions (``exact=True`` means precisely
        the matches, so re-evaluation can be skipped), or ``None`` when the
        index cannot bound this query — the caller falls back to a full
        scan.  Soundness rule: a position may only be *excluded* when the
        index proves the record cannot match.
        """
        return None

    def fingerprint(self) -> str:
        """Deterministic digest; THE cache key for snapshot dedup."""
        blob = json.dumps(self.canonical(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    # -- misc ---------------------------------------------------------------

    def __eq__(self, other) -> bool:
        return (isinstance(other, Query) and self.serializable
                and other.serializable
                and self.canonical() == other.canonical())

    def __hash__(self) -> int:
        return hash(self.fingerprint())

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.to_json()!r})"


def _flatten(kind, args: Sequence[Query]) -> List[Query]:
    out: List[Query] = []
    for a in args:
        if isinstance(a, kind):
            out.extend(a.args)
        else:
            out.append(a)
    return out


class TrueQuery(Query):
    """Matches everything (the default checkout query)."""

    def __call__(self, entry) -> bool:
        return True

    def index_plan(self, index) -> Optional[Tuple[set, bool]]:
        return index.all_positions(), True

    def to_json(self) -> dict:
        return {"op": "true"}

    def __and__(self, other: Query) -> Query:
        return other if isinstance(other, Query) else NotImplemented

    def __or__(self, other: Query) -> Query:
        return self if isinstance(other, Query) else NotImplemented


ALL = TrueQuery()

_CMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge", "in", "contains", "any_in",
            "glob", "exists")


class Cmp(Query):
    """Leaf comparison on one attribute (or the record id via field 'id')."""

    def __init__(self, field: str, cmp: str, value=None):
        if cmp not in _CMP_OPS:
            raise ValueError(f"unknown comparison {cmp!r}")
        self.field = field
        self.cmp = cmp
        self.value = value

    def _resolve(self, entry):
        if self.field in ("id", "record_id"):
            return entry.record_id, True
        attrs = getattr(entry, "attrs", {}) or {}
        return attrs.get(self.field), self.field in attrs

    def __call__(self, entry) -> bool:
        have, present = self._resolve(entry)
        return self._eval_value(have, present)

    def _eval_value(self, have, present: bool) -> bool:
        """Evaluate the comparison on an already-resolved ``(value,
        present)`` pair — shared by entry evaluation and the index planner
        (which probes posting-class representatives), so the two can never
        drift semantically."""
        want = self.value
        try:
            if self.cmp == "exists":
                return present
            if self.cmp == "eq":
                return have == want
            if self.cmp == "ne":
                return have != want
            if not present and self.cmp != "ne":
                return False
            if self.cmp == "lt":
                return have < want
            if self.cmp == "le":
                return have <= want
            if self.cmp == "gt":
                return have > want
            if self.cmp == "ge":
                return have >= want
            if self.cmp == "in":
                return have in want
            if self.cmp == "contains":
                return want in have
            if self.cmp == "any_in":
                return bool(set(have) & set(want))
            if self.cmp == "glob":
                if isinstance(have, (list, tuple, set, frozenset)):
                    # element-wise: tags~=gold* matches ["golden", ...]
                    return any(fnmatch.fnmatchcase(str(x), str(want))
                               for x in have)
                return fnmatch.fnmatchcase(str(have), str(want))
        except TypeError:
            return False
        raise AssertionError(self.cmp)  # pragma: no cover

    def index_plan(self, index) -> Optional[Tuple[set, bool]]:
        if self.field in ("id", "record_id"):
            return None  # the record-id pseudo-field is not attr-indexed
        postings = index.postings_for(self.field)
        if postings is not None:
            # Evaluate the predicate once per distinct posting class.  A
            # numeric class representative (int/float/bool collapse) gives
            # the same answer as any member for every op except glob, whose
            # str() differs across the class — include those unconditionally
            # and let re-evaluation filter.
            out: set = set()
            exact = True
            present: set = set()
            for key, positions in postings.items():
                present.update(positions)
                if self.cmp == "glob" and not key.startswith("s:"):
                    out.update(positions)
                    exact = False
                elif self._eval_value(_index_decode_key(key), True):
                    out.update(positions)
            if self._eval_value(None, False):
                # predicate matches records lacking the field (eq None,
                # ne ...); posting lists are complete, so absence is exact
                out |= index.all_positions() - present
            return out, exact
        spans = index.zone_spans_for(self.field)
        if spans is not None and self.cmp in ("eq", "lt", "le", "gt", "ge"):
            want = self.value
            if isinstance(want, bool):
                want = int(want)
            if isinstance(want, (int, float)):
                # Only numeric values can satisfy a numeric range predicate
                # (str <op> number raises -> False; absent fails the present
                # check), so spans whose numeric [min, max] cannot reach
                # the bound are safely pruned.  Superset: re-evaluate.
                # All comparisons are NON-strict: zone bounds and ``w`` are
                # float-rounded (ints >= 2**53 collapse), so `lo < w` could
                # prune a span holding a true `have < want` match whose
                # float images are equal.  have < want only guarantees
                # float(have) <= float(want), hence `lo <= w`.
                w = float(want)
                out = set()
                for start, end, lo, hi in spans:
                    hit = (lo <= w if self.cmp in ("lt", "le") else
                           hi >= w if self.cmp in ("gt", "ge") else
                           lo <= w <= hi)
                    if hit:
                        out.update(range(start, end))
                return out, False
        return None

    @property
    def serializable(self) -> bool:
        # A comparison against a non-JSON value (bytes, datetime, set...)
        # still evaluates, but cannot be serialized or fingerprinted — it
        # must take the opaque/uncached checkout path, not crash it.
        try:
            json.dumps(self.value)
        except (TypeError, ValueError):
            return False
        return True

    def to_json(self) -> dict:
        out = {"op": "cmp", "field": self.field, "cmp": self.cmp}
        if self.cmp != "exists":
            out["value"] = self.value
        return out

    def canonical(self) -> dict:
        out = self.to_json()
        # Membership is order-insensitive; sort so `x in [b,a]` and
        # `x in [a,b]` fingerprint (and snapshot-dedup) identically.
        if self.cmp in ("in", "any_in") and isinstance(
                out.get("value"), (list, tuple)):
            out["value"] = sorted(out["value"], key=repr)
        return out


class And(Query):
    def __init__(self, args: Sequence[Query]):
        self.args = list(args)

    def __call__(self, entry) -> bool:
        return all(a(entry) for a in self.args)

    def index_plan(self, index) -> Optional[Tuple[set, bool]]:
        # Intersection of whatever conjuncts the index can bound; an
        # unresolvable conjunct just stops narrowing (and forces re-eval).
        out: Optional[set] = None
        exact = True
        for a in self.args:
            plan = a.index_plan(index)
            if plan is None:
                exact = False
                continue
            s, e = plan
            out = set(s) if out is None else out & s
            exact = exact and e
        if out is None:
            return None
        return out, exact

    @property
    def serializable(self) -> bool:
        return all(a.serializable for a in self.args)

    def to_json(self) -> dict:
        return {"op": "and", "args": [a.to_json() for a in self.args]}

    def canonical(self) -> dict:
        # TRUE is the AND identity; a singleton AND is its only arg — both
        # must canonicalize away so `q & ALL` fingerprints equal to `q`.
        args = sorted((c for c in (a.canonical()
                                   for a in _flatten(And, self.args))
                       if c != {"op": "true"}),
                      key=lambda o: json.dumps(o, sort_keys=True))
        if not args:
            return {"op": "true"}
        if len(args) == 1:
            return args[0]
        return {"op": "and", "args": args}


class Or(Query):
    def __init__(self, args: Sequence[Query]):
        self.args = list(args)

    def __call__(self, entry) -> bool:
        return any(a(entry) for a in self.args)

    def index_plan(self, index) -> Optional[Tuple[set, bool]]:
        # Every disjunct must be bounded, or the union has no upper bound.
        out: set = set()
        exact = True
        for a in self.args:
            plan = a.index_plan(index)
            if plan is None:
                return None
            s, e = plan
            out |= s
            exact = exact and e
        return out, exact

    @property
    def serializable(self) -> bool:
        return all(a.serializable for a in self.args)

    def to_json(self) -> dict:
        return {"op": "or", "args": [a.to_json() for a in self.args]}

    def canonical(self) -> dict:
        args = sorted((a.canonical() for a in _flatten(Or, self.args)),
                      key=lambda o: json.dumps(o, sort_keys=True))
        if any(c == {"op": "true"} for c in args):
            return {"op": "true"}  # TRUE absorbs OR
        if len(args) == 1:
            return args[0]
        return {"op": "or", "args": args}


class Not(Query):
    def __init__(self, arg: Query):
        self.arg = arg

    def __call__(self, entry) -> bool:
        return not self.arg(entry)

    def index_plan(self, index) -> Optional[Tuple[set, bool]]:
        # Complement is only sound against an *exact* inner set: the
        # complement of a superset would drop true matches.
        plan = self.arg.index_plan(index)
        if plan is None or not plan[1]:
            return None
        return index.all_positions() - plan[0], True

    @property
    def serializable(self) -> bool:
        return self.arg.serializable

    def to_json(self) -> dict:
        return {"op": "not", "arg": self.arg.to_json()}

    def canonical(self) -> dict:
        return {"op": "not", "arg": self.arg.canonical()}


class Opaque(Query):
    """Adapter for a legacy Python-callable predicate.

    Works for evaluation but cannot be serialized or fingerprinted, so
    checkouts through it never hit the snapshot cache.  Exists purely as
    the deprecation shim for pre-algebra callers.
    """

    def __init__(self, fn: Callable[[object], bool]):
        self.fn = fn

    def __call__(self, entry) -> bool:
        return bool(self.fn(entry))

    @property
    def serializable(self) -> bool:
        return False

    def to_json(self) -> dict:
        raise TypeError("opaque (callable) predicates are not serializable; "
                        "build the query with repro_torch.core.query.attr(...) "
                        "instead")

    def fingerprint(self) -> str:
        raise TypeError("opaque (callable) predicates have no stable "
                        "fingerprint")


# ---------------------------------------------------------------------------
# Builder helpers
# ---------------------------------------------------------------------------


class _AttrProxy:
    """``attr("lang") == "en"`` → :class:`Cmp`; comparison sugar."""

    __slots__ = ("field",)

    def __init__(self, field: str):
        self.field = field

    def __eq__(self, value) -> Cmp:  # type: ignore[override]
        return Cmp(self.field, "eq", value)

    def __ne__(self, value) -> Cmp:  # type: ignore[override]
        return Cmp(self.field, "ne", value)

    def __lt__(self, value) -> Cmp:
        return Cmp(self.field, "lt", value)

    def __le__(self, value) -> Cmp:
        return Cmp(self.field, "le", value)

    def __gt__(self, value) -> Cmp:
        return Cmp(self.field, "gt", value)

    def __ge__(self, value) -> Cmp:
        return Cmp(self.field, "ge", value)

    def isin(self, *values) -> Cmp:
        if len(values) == 1 and isinstance(values[0], (list, tuple, set)):
            values = tuple(values[0])
        return Cmp(self.field, "in", sorted(values, key=repr))

    def contains(self, value) -> Cmp:
        return Cmp(self.field, "contains", value)

    def glob(self, pattern: str) -> Cmp:
        return Cmp(self.field, "glob", pattern)

    def exists(self) -> Cmp:
        return Cmp(self.field, "exists")

    def __hash__(self):
        return hash(("attr", self.field))


def attr(field: str) -> _AttrProxy:
    """Start a comparison on a record attribute."""
    return _AttrProxy(field)


def tag_in(*tags: str) -> Cmp:
    """Match records whose ``tags`` attribute intersects the given tags."""
    return Cmp("tags", "any_in", sorted(tags))


def record_id_in(*ids: str) -> Cmp:
    """Match an explicit record-id set."""
    if len(ids) == 1 and isinstance(ids[0], (list, tuple, set)):
        ids = tuple(ids[0])
    return Cmp("id", "in", sorted(ids))


def as_query(where) -> Optional[Query]:
    """Normalize any accepted ``where`` form into a :class:`Query`.

    Accepts: None, Query, JSON dict, CLI string, or a bare callable
    (wrapped as :class:`Opaque` — the deprecation path).
    """
    if where is None:
        return None
    if isinstance(where, Query):
        return where
    if isinstance(where, dict):
        return Query.from_json(where)
    if isinstance(where, str):
        return parse_where(where)
    if callable(where):
        return Opaque(where)
    raise TypeError(f"cannot interpret {type(where).__name__} as a query")


# ---------------------------------------------------------------------------
# CLI string parser
# ---------------------------------------------------------------------------


class QueryParseError(ValueError):
    """Malformed ``--where`` expression."""


_TOKEN_RE = re.compile(
    r"""\s*(?:
      (?P<lparen>\()
    | (?P<rparen>\))
    | (?P<amp>&)
    | (?P<pipe>\|)
    | (?P<op>!=|<=|>=|==|~=|=|<|>)
    | (?P<tilde>~)
    | (?P<lbrack>\[)
    | (?P<rbrack>\])
    | (?P<comma>,)
    | (?P<string>'[^']*'|"[^"]*")
    | (?P<word>[A-Za-z0-9_.\-/*?]+)
    )""",
    re.X,
)

_OP_MAP = {"=": "eq", "==": "eq", "!=": "ne", "<": "lt", "<=": "le",
           ">": "gt", ">=": "ge", "~=": "glob"}


def _tokenize(text: str) -> List[tuple]:
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None or m.end() == pos:
            if text[pos:].strip() == "":
                break
            raise QueryParseError(
                f"unexpected character {text[pos:].lstrip()[0]!r} at "
                f"offset {pos} in {text!r}")
        pos = m.end()
        kind = m.lastgroup
        val = m.group(kind)
        if kind == "string":
            toks.append(("value", val[1:-1]))
        elif kind == "word":
            toks.append(("word", val))
        else:
            toks.append((kind, val))
    return toks


def _coerce(raw: str):
    low = raw.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low in ("null", "none"):
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


class _Parser:
    def __init__(self, toks: List[tuple], text: str):
        self.toks = toks
        self.text = text
        self.i = 0

    def peek(self) -> Optional[tuple]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> tuple:
        tok = self.peek()
        if tok is None:
            raise QueryParseError(f"unexpected end of query in {self.text!r}")
        self.i += 1
        return tok

    def expect(self, kind: str) -> tuple:
        tok = self.next()
        if tok[0] != kind:
            raise QueryParseError(
                f"expected {kind} but found {tok[1]!r} in {self.text!r}")
        return tok

    # expr := term ('|' term)*
    def expr(self) -> Query:
        node = self.term()
        while self.peek() and self.peek()[0] == "pipe":
            self.next()
            node = node | self.term()
        return node

    # term := factor ('&' factor)*
    def term(self) -> Query:
        node = self.factor()
        while self.peek() and self.peek()[0] == "amp":
            self.next()
            node = node & self.factor()
        return node

    # factor := '~' factor | '(' expr ')' | cmp
    def factor(self) -> Query:
        tok = self.peek()
        if tok is None:
            raise QueryParseError(f"unexpected end of query in {self.text!r}")
        if tok[0] == "tilde":
            self.next()
            return ~self.factor()
        if tok[0] == "lparen":
            self.next()
            node = self.expr()
            self.expect("rparen")
            return node
        return self.cmp()

    def _value(self):
        tok = self.next()
        if tok[0] == "value":
            return tok[1]
        if tok[0] == "word":
            return _coerce(tok[1])
        raise QueryParseError(
            f"expected a value but found {tok[1]!r} in {self.text!r}")

    def cmp(self) -> Query:
        tok = self.next()
        if tok[0] not in ("word", "value"):
            raise QueryParseError(
                f"expected a field name but found {tok[1]!r} in {self.text!r}")
        field = tok[1]
        nxt = self.peek()
        if nxt is None or nxt[0] in ("amp", "pipe", "rparen"):
            return Cmp(field, "exists")
        if nxt[0] == "op":
            self.next()
            return Cmp(field, _OP_MAP[nxt[1]], self._value())
        if nxt[0] == "word" and nxt[1] == "in":
            self.next()
            self.expect("lbrack")
            values = [self._value()]
            while self.peek() and self.peek()[0] == "comma":
                self.next()
                values.append(self._value())
            self.expect("rbrack")
            return Cmp(field, "in", values)
        raise QueryParseError(
            f"expected an operator after {field!r} in {self.text!r}")


def parse_where(text: str) -> Query:
    """Parse a CLI ``--where`` string into a :class:`Query`.

    >>> parse_where("lang=en & split!=test")
    >>> parse_where("(score>=0.5 | tags~=gold*) & ~flagged")
    """
    toks = _tokenize(text)
    if not toks:
        return ALL
    p = _Parser(toks, text)
    node = p.expr()
    if p.peek() is not None:
        raise QueryParseError(
            f"trailing tokens starting at {p.peek()[1]!r} in {text!r}")
    return node
