"""Platform CLI — the paper's "Users can use a command-line interface (CLI)
or other user interface to check-in data".

Every command opens the repository through :class:`repro_torch.Platform`
(``Platform.open(repo_dir)``) and operates on dataset handles, so the CLI,
library callers, and workflows share one code path.  ``--where`` takes the
declarative query grammar of :func:`repro_torch.core.query.parse_where` —
the same serializable algebra workflows use for their input queries, so a
query shown in a run report can be pasted back into the CLI verbatim.

A repository lives in a directory (FileBackend CAS).  Actors are passed via
``--actor`` (or $REPRO_ACTOR); ACL is enforced on every operation.

Examples:
    repro-cli --repo /tmp/repo check-in mydata file1.txt file2.bin -m "v1"
    repro-cli --repo /tmp/repo checkout mydata --out /tmp/restore
    repro-cli --repo /tmp/repo checkout mydata --where 'lang=en & split!=test'
    repro-cli --repo /tmp/repo checkout mydata --where 'size>=1024 | tags~=gold*'
    repro-cli --repo /tmp/repo derive mydata --pipeline clean \\
        --where 'lang=en' --output mydata-clean --pipelines-module my.pipes
    repro-cli --repo /tmp/repo tag mydata golden
    repro-cli --repo /tmp/repo datasets --tags text
    repro-cli --repo /tmp/repo log mydata
    repro-cli --repo /tmp/repo diff mydata <rev-a> <rev-b>
    repro-cli --repo /tmp/repo lineage <node-id>
    repro-cli --repo /tmp/repo revoke <record-id> --reason "user request"
    repro-cli --repo /tmp/repo grant alice 'speech/*' WRITE
    repro-cli --repo /tmp/repo cache ls
    repro-cli --repo /tmp/repo cache stats
    repro-cli --repo /tmp/repo cache prune --keep-latest 2
    repro-cli --repo /tmp/repo store stats
    repro-cli --repo 'http://localhost:8123' datasets

``--repo`` also accepts backend URLs (``memory://``, ``file:///path``,
``http://host:port`` — see :mod:`repro_torch.store.remote.urls`), so the same
commands run against a remote object server; ``store stats`` then shows
the remote request / retry / hedge counters next to the cache tiers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .core import (NotFoundError, QueryParseError, Record, get_pipeline,
                   parse_where)
from .core.query import ALL
from .platform import Platform

__all__ = ["main"]


def _open(args) -> Platform:
    return Platform.open(args.repo, actor=args.actor)


def _at_least_one(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return value


def _parse_where_args(where_args: Optional[List[str]]):
    """AND together every repeated ``--where`` expression."""
    query = None
    for text in where_args or []:
        q = parse_where(text)
        query = q if query is None else query & q
    return query


def cmd_check_in(plat: Platform, args) -> int:
    records = []
    for path in args.files:
        with open(path, "rb") as f:
            data = f.read()
        records.append(Record(os.path.basename(path), data,
                              {"src_path": os.path.abspath(path)}))
    c = plat.dataset(args.dataset).check_in(
        records, message=args.message or "", version_tags=args.tag or [])
    print(f"checked in {len(records)} record(s) -> {c.commit_id}")
    return 0


def cmd_checkout(plat: Platform, args) -> int:
    plan = plat.dataset(args.dataset).plan(
        rev=args.rev, where=_parse_where_args(args.where), limit=args.limit)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        # entries() caches the scan, so the snapshot() below reuses it
        for entry in plan.entries():
            with open(os.path.join(args.out, entry.record_id), "wb") as f:
                f.write(plat.store.get_blob(entry.blob))
        print(f"materialized {len(plan.entries())} record(s) to {args.out}")
        snap = plan.snapshot()
    else:
        snap = plan.snapshot()
        for entry in snap.entries():   # stream: no separate id list + lookup
            print(entry.record_id, json.dumps(dict(entry.attrs)))
    digest = plan.query_digest()
    print(f"snapshot {snap.snapshot_id} @ {snap.commit_id[:12]} "
          f"(query {digest[:12] if digest else 'opaque'})")
    return 0


def cmd_derive(plat: Platform, args) -> int:
    """Run a registered pipeline over a queried checkout — cached,
    incremental, streaming (the derivation engine)."""
    if args.pipelines_module:
        import importlib

        try:
            importlib.import_module(args.pipelines_module)
        except ImportError as e:
            raise NotFoundError(
                f"cannot import --pipelines-module "
                f"{args.pipelines_module!r}: {e}") from e
    pipeline = get_pipeline(args.pipeline)
    res = plat.dataset(args.dataset).derive(
        pipeline, output=args.output, rev=args.rev,
        where=_parse_where_args(args.where),
        use_cache=not args.no_cache, incremental=not args.no_cache,
        update_cache=not args.no_cache,
    )
    print(f"derivation {res.key or 'opaque (uncached)'}")
    if res.cache_hit:
        print(f"cache hit: {res.n_inputs} record(s), 0 executed")
    else:
        print(f"cache miss: {res.n_executed} executed, "
              f"{res.n_reused} reused of {res.n_inputs} record(s) "
              f"-> {res.n_outputs} output record(s)"
              + (" [incremental]" if res.incremental else ""))
    print(f"output commit {res.output_commit}")
    return 0


def cmd_datasets(plat: Platform, args) -> int:
    for ds in plat.datasets(args.glob, tags=args.tags or []):
        info = ds.info() or {}
        print(ds.name, json.dumps(info.get("tags", [])))
    return 0


def cmd_log(plat: Platform, args) -> int:
    for c in plat.dataset(args.dataset).log(rev=args.rev, limit=args.limit):
        print(f"{c.commit_id[:12]} {c.author:12s} {c.message}")
    return 0


def cmd_diff(plat: Platform, args) -> int:
    d = plat.dataset(args.dataset).diff(args.rev_a, args.rev_b)
    print(d.summary())
    for rid in d.added:
        print(f"A {rid}")
    for rid in d.removed:
        print(f"D {rid}")
    for rid in d.modified:
        print(f"M {rid}")
    return 0


def cmd_tag(plat: Platform, args) -> int:
    plat.dataset(args.dataset).tag_version(args.rev, args.tag)
    print(f"tagged {args.dataset}@{args.rev} as {args.tag}")
    return 0


def cmd_query(plat: Platform, args) -> int:
    """Inspect a --where expression: parsed JSON + stable fingerprint."""
    query = _parse_where_args(args.where) or ALL
    print(json.dumps(query.to_json(), indent=2))
    print(f"fingerprint {query.fingerprint()}")
    return 0


def cmd_lineage(plat: Platform, args) -> int:
    node = plat.lineage.node(args.node)
    if node is None:
        print(f"unknown node {args.node!r}", file=sys.stderr)
        return 1
    print("node:", json.dumps(node.to_json(), indent=2))
    print("ancestors:")
    for n in plat.ancestors(args.node):
        print("  <-", n)
    print("descendants:")
    for n in plat.descendants(args.node):
        print("  ->", n)
    return 0


def cmd_revoke(plat: Platform, args) -> int:
    report = plat.revoke(args.record, reason=args.reason or "")
    print(json.dumps(report.to_json(), indent=2))
    return 0


def cmd_grant(plat: Platform, args) -> int:
    plat.grant(args.subject, args.pattern, args.action)
    print(f"granted {args.action} on {args.pattern!r} to {args.subject}")
    return 0


def cmd_gc(plat: Platform, args) -> int:
    n = plat.gc()
    print(f"collected {n} unreachable object(s)")
    return 0


def _cache_slot_rows(plat: Platform):
    """(key, entry, prov size) rows of the derivation cache, newest first.

    The size comes from the slot's recorded ``prov_bytes`` — reading every
    prov blob just to len() it would make a listing cost O(total prov
    bytes); pre-PR-4 slots without the field show "-"."""
    rows = [(key, entry, entry.get("prov_bytes"))
            for key, entry in plat.derivations.cache.entries().items()]
    rows.sort(key=lambda r: r[1].get("created_at", 0.0), reverse=True)
    return rows


def cmd_cache(plat: Platform, args) -> int:
    """Inspect / prune the derivation cache (``cache ls`` / ``cache stats``
    / ``cache prune --keep-latest N``)."""
    cache = plat.derivations.cache
    if args.cache_cmd == "ls":
        rows = _cache_slot_rows(plat)
        if not rows:
            print("derivation cache is empty")
            return 0
        print("key,output_dataset,output_commit,n_inputs,n_outputs,"
              "prov_bytes,created_at")
        for key, entry, size in rows:
            created = entry.get("created_at")
            print(",".join(str(x) for x in (
                key,
                entry.get("output_dataset"),
                (entry.get("output_commit") or "")[:12],
                entry.get("n_inputs", 0),
                entry.get("n_outputs", 0),
                size if size is not None else "-",
                f"{created:.0f}" if created else "-")))
        return 0
    if args.cache_cmd == "stats":
        rows = _cache_slot_rows(plat)
        groups = {(e.get("query"), e.get("pipeline"),
                   e.get("output_dataset")) for _, e, _ in rows}
        prov_bytes = sum(size or 0 for _, _, size in rows)
        print(f"slots {len(rows)}")
        print(f"groups {len(groups)}  (distinct query+pipeline+output)")
        print(f"superseded {len(rows) - len(groups)}")
        print(f"prov_bytes {prov_bytes}")
        return 0
    if args.cache_cmd == "prune":
        removed = cache.prune(keep_latest=args.keep_latest)
        collected = plat.gc()
        print(f"pruned {len(removed)} superseded slot(s) "
              f"(kept latest {args.keep_latest} per group), "
              f"gc collected {collected} object(s)")
        return 0
    raise AssertionError(args.cache_cmd)  # pragma: no cover


def cmd_store(plat: Platform, args) -> int:
    """Storage-engine introspection (``store stats``)."""
    if args.store_cmd == "stats":
        print(json.dumps(plat.store_stats(), indent=2, sort_keys=True))
        return 0
    raise AssertionError(args.store_cmd)  # pragma: no cover


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro-cli",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--repo", required=True,
                    help="repository directory, or a backend URL "
                         "(memory://, file:///path, http://host:port)")
    ap.add_argument("--actor", default=os.environ.get("REPRO_ACTOR", "cli"))
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("check-in")
    p.add_argument("dataset")
    p.add_argument("files", nargs="+")
    p.add_argument("-m", "--message")
    p.add_argument("--tag", action="append")
    p.set_defaults(fn=cmd_check_in)

    p = sub.add_parser("checkout")
    p.add_argument("dataset")
    p.add_argument("--rev", default="main")
    p.add_argument("--out")
    p.add_argument("--where", action="append",
                   help="query expression, e.g. 'lang=en & split!=test' "
                        "(repeatable; repeats are ANDed). Bare values are "
                        "coerced to int/float/bool; quote to force a "
                        "string or to include spaces: \"k='some value'\"")
    p.add_argument("--limit", type=int)
    p.set_defaults(fn=cmd_checkout)

    p = sub.add_parser("query",
                       help="parse a --where expression and print its "
                            "JSON + fingerprint")
    p.add_argument("--where", action="append", required=True)
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser("derive",
                       help="run a registered pipeline over a queried "
                            "checkout and check the result into --output "
                            "(cached on the derivation key)")
    p.add_argument("dataset")
    p.add_argument("--pipeline", required=True,
                   help="pipeline name registered via "
                        "repro_torch.core.derive.register_pipeline")
    p.add_argument("--output", required=True,
                   help="dataset the derived version is checked into")
    p.add_argument("--rev", default="main")
    p.add_argument("--where", action="append",
                   help="same query algebra as checkout (repeats ANDed)")
    p.add_argument("--pipelines-module",
                   help="import this module first so it can register "
                        "pipelines")
    p.add_argument("--no-cache", action="store_true",
                   help="force a full recompute; do not read or write "
                        "the derivation cache")
    p.set_defaults(fn=cmd_derive)

    p = sub.add_parser("datasets")
    p.add_argument("--glob", default="*")
    p.add_argument("--tags", action="append")
    p.set_defaults(fn=cmd_datasets)

    p = sub.add_parser("log")
    p.add_argument("dataset")
    p.add_argument("--rev", default="main")
    p.add_argument("--limit", type=int, default=20)
    p.set_defaults(fn=cmd_log)

    p = sub.add_parser("diff")
    p.add_argument("dataset")
    p.add_argument("rev_a")
    p.add_argument("rev_b")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("tag")
    p.add_argument("dataset")
    p.add_argument("tag")
    p.add_argument("--rev", default="main")
    p.set_defaults(fn=cmd_tag)

    p = sub.add_parser("lineage")
    p.add_argument("node")
    p.set_defaults(fn=cmd_lineage)

    p = sub.add_parser("revoke")
    p.add_argument("record")
    p.add_argument("--reason")
    p.set_defaults(fn=cmd_revoke)

    p = sub.add_parser("grant")
    p.add_argument("subject")
    p.add_argument("pattern")
    p.add_argument("action", choices=["READ", "WRITE", "ADMIN"])
    p.set_defaults(fn=cmd_grant)

    p = sub.add_parser("gc")
    p.set_defaults(fn=cmd_gc)

    p = sub.add_parser("cache",
                       help="inspect or prune the derivation cache")
    cache_sub = p.add_subparsers(dest="cache_cmd", required=True)
    cache_sub.add_parser("ls", help="list cache slots, newest first")
    cache_sub.add_parser("stats", help="slot/group/provenance-size summary")
    cp = cache_sub.add_parser(
        "prune",
        help="drop superseded slots (older input commits of the same "
             "query+pipeline+output), then run gc")
    cp.add_argument("--keep-latest", type=_at_least_one, default=1,
                    metavar="N", help="slots to keep per group (default 1)")
    p.set_defaults(fn=cmd_cache)

    p = sub.add_parser("store",
                       help="storage-engine introspection")
    store_sub = p.add_subparsers(dest="store_cmd", required=True)
    store_sub.add_parser(
        "stats",
        help="read/write/cache/remote counters — incl. meta_requests/"
             "meta_batched/ref_cas_retries — + both cache tiers (JSON)")
    p.set_defaults(fn=cmd_store)

    args = ap.parse_args(argv)
    plat = _open(args)
    try:
        return args.fn(plat, args)
    except QueryParseError as e:
        print(f"error: bad --where expression: {e}", file=sys.stderr)
        return 2
    except NotFoundError as e:
        print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
