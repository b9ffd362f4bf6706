"""Data-lake object-store CLI (checkpoint/cloud.py): poke any backend the
runtime can talk to — cloud bucket, local directory, in-process test
double — through the one shared URL syntax (counterpart of the JAX
package's ``tools/lake.py``).

    # list a bucket (credentials from DLT_LAKE_* / AWS_* env or --access-key)
    python -m deeplearning4j_tpu_torch.tools.lake ls http://127.0.0.1:9000/lake --prefix shards/

    # fetch / upload one object (multipart above the client threshold)
    python -m deeplearning4j_tpu_torch.tools.lake get http://127.0.0.1:9000/lake shards/meta.json
    python -m deeplearning4j_tpu_torch.tools.lake put http://127.0.0.1:9000/lake model.zip --in model.zip

    # reap stale tmp-* keys and abandoned multipart uploads
    python -m deeplearning4j_tpu_torch.tools.lake gc http://127.0.0.1:9000/lake

    # disk-cache layer: point any command at a cache dir; cache-stats
    # reports its hit rate / byte budget
    python -m deeplearning4j_tpu_torch.tools.lake get ... --cache-dir /var/cache/lake
    python -m deeplearning4j_tpu_torch.tools.lake cache-stats file:/ckpts --cache-dir /var/cache/lake

URLs: ``http(s)://host:port/bucket`` (CloudObjectBackend behind bounded
retries, Retry-After honored), ``file:/path`` or a bare path
(LocalFSBackend), ``mem:`` (fresh in-process store — only useful for
exercising the CLI itself).
"""

from __future__ import annotations

import argparse
import sys

# uploads are staged fully in memory (the client's put contract), so the
# CLI bounds what it will read from a local file
MAX_PUT_BYTES = 1 << 31


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("url", help="backend URL: http(s)://host:port/"
                                    "bucket, file:/path, bare path, mem:")
        sp.add_argument("--cache-dir", default=None,
                        help="wrap the backend in a local-disk LRU cache")
        sp.add_argument("--cache-bytes", type=int, default=256 << 20)
        sp.add_argument("--access-key", default=None,
                        help="override env/file credential resolution")
        sp.add_argument("--secret-key", default=None)
        sp.add_argument("--timeout-s", type=float, default=10.0)
        sp.add_argument("--retries", type=int, default=5)
        return sp

    ls = common(sub.add_parser("ls", help="list object names"))
    ls.add_argument("--prefix", default="", help="name prefix filter")
    ls.add_argument("-l", "--long", action="store_true",
                    help="also fetch and print each object's size")

    get = common(sub.add_parser("get", help="fetch one object"))
    get.add_argument("key")
    get.add_argument("--out", default=None,
                     help="write here instead of stdout")

    put = common(sub.add_parser("put", help="upload one object"))
    put.add_argument("key")
    put.add_argument("--in", dest="infile", required=True,
                     help="local file to upload")

    common(sub.add_parser(
        "gc", help="clean_orphans: delete tmp-*/.part keys and abort "
                   "abandoned multipart uploads"))

    common(sub.add_parser("cache-stats",
                          help="print the --cache-dir tier's counters"))
    return p


def _backend(args):
    from deeplearning4j_tpu_torch.checkpoint.cloud import backend_from_url
    return backend_from_url(
        args.url, cache_dir=args.cache_dir, cache_bytes=args.cache_bytes,
        retries=args.retries, timeout_s=args.timeout_s,
        access_key=args.access_key, secret_key=args.secret_key)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    backend = _backend(args)

    if args.cmd == "ls":
        for name in backend.list(prefix=args.prefix):
            if args.long:
                print(f"{len(backend.get(name)):>12}  {name}")
            else:
                print(name)
        return 0

    if args.cmd == "get":
        data = backend.get(args.key)
        if args.out:
            with open(args.out, "wb") as f:
                f.write(data)
            print(f"{args.key}: {len(data)} bytes -> {args.out}",
                  file=sys.stderr)
        else:
            sys.stdout.buffer.write(data)
        return 0

    if args.cmd == "put":
        with open(args.infile, "rb") as f:
            data = f.read(MAX_PUT_BYTES + 1)
        if len(data) > MAX_PUT_BYTES:
            print(f"{args.infile} exceeds the {MAX_PUT_BYTES}-byte "
                  "single-object bound", file=sys.stderr)
            return 1
        backend.put(args.key, data)
        print(f"{args.key}: {len(data)} bytes uploaded", file=sys.stderr)
        return 0

    if args.cmd == "gc":
        swept = backend.clean_orphans()
        for name in swept or ():
            print(name)
        print(f"swept {len(swept or ())} orphan(s)", file=sys.stderr)
        return 0

    if args.cmd == "cache-stats":
        if not args.cache_dir:
            print("cache-stats needs --cache-dir", file=sys.stderr)
            return 1
        for k, v in sorted(backend.stats().items()):
            print(f"{k}: {v}")
        return 0

    return 2  # unreachable: argparse enforces the subcommand set


if __name__ == "__main__":
    raise SystemExit(main())
