"""Run the port's linter (``analysis/lint.py``) over the port.

Usage:
    python -m deeplearning4j_tpu_torch.tools.run_lint [options] [path ...]

With no paths lints the port's surface (``lint.DEFAULT_TARGETS``):
``deeplearning4j_tpu_torch/``, ``chip_smoke.py`` and the repo-root tools
that import ``torch`` or the port. Exits 1 on any violation (or, with
``--audit-waivers``, on any stale waiver), 2 on a bad option: the contract
``tests/test_torch_lint.py`` holds, and the JAX tool's.

Options:
    --json            machine-readable output: one object with
                      ``violations`` (rule/file/line/message, plus
                      ``chain``, the resolved call chain, for
                      interprocedural findings), ``count`` and, with
                      ``--audit-waivers``, ``stale_waivers``.
    --rule DLT0XX     only report the named rule(s); repeatable, and a
                      comma-separated list works too. Filters reporting
                      only: the whole call graph is still built.
    --changed-only    only report findings in files changed vs git HEAD
                      (staged, unstaged or untracked). The graph is still
                      built over the full targets.
    --audit-waivers   also flag ``# lint: disable=...`` comments that no
                      longer suppress any finding.

The rules, each with the JAX hazard it stands for and the port's
counterpart, are documented in ``analysis/lint.py``; the README carries
the rule table.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

from deeplearning4j_tpu_torch.analysis.lint import (DEFAULT_TARGETS, audit_waivers,
                                                    lint_paths)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_CHAIN_RE = re.compile(r"via ([^(]+?) \(\d+ call hop")
_RULE_RE = re.compile(r"^DLT\d{3}$")


def _chain_of(message: str):
    """The resolved call chain embedded in a DLT017 message, or None."""
    m = _CHAIN_RE.search(message)
    if not m:
        return None
    return [part.strip() for part in m.group(1).split("->")]


def _changed_files(repo_root: str):
    """Absolute paths changed vs HEAD (staged+unstaged) plus untracked."""
    out = set()
    for args in (["git", "diff", "--name-only", "HEAD"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            proc = subprocess.run(args, cwd=repo_root, capture_output=True,
                                  text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line:
                out.add(os.path.abspath(os.path.join(repo_root, line)))
    return out


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    repo_root = REPO_ROOT
    as_json = False
    changed_only = False
    audit = False
    rules = set()
    targets = []
    args = list(argv[1:])
    while args:
        a = args.pop(0)
        if a == "--json":
            as_json = True
        elif a == "--changed-only":
            changed_only = True
        elif a == "--audit-waivers":
            audit = True
        elif a == "--rule":
            if not args:
                print("--rule needs an argument (e.g. --rule DLT017)",
                      file=sys.stderr)
                return 2
            rules.update(r.strip() for r in args.pop(0).split(",") if r)
        elif a.startswith("--rule="):
            rules.update(r.strip() for r in a.split("=", 1)[1].split(",")
                         if r)
        elif a.startswith("-"):
            print(f"unknown option: {a}", file=sys.stderr)
            return 2
        else:
            targets.append(a)
    for r in rules:
        if not _RULE_RE.match(r):
            print(f"--rule expects DLT0XX ids, got: {r}", file=sys.stderr)
            return 2

    targets = targets or DEFAULT_TARGETS(repo_root)
    violations = lint_paths(targets)
    stale = audit_waivers(targets) if audit else []

    if changed_only:
        changed = _changed_files(repo_root)
        if changed is None:
            print("--changed-only: git unavailable, reporting everything",
                  file=sys.stderr)
        else:
            violations = [v for v in violations
                          if os.path.abspath(v.file) in changed]
            stale = [s for s in stale if os.path.abspath(s.file) in changed]
    if rules:
        violations = [v for v in violations if v.rule in rules]

    if as_json:
        payload = {
            "violations": [
                {"rule": v.rule, "file": v.file, "line": v.line,
                 "message": v.message, "chain": _chain_of(v.message)}
                for v in violations],
            "count": len(violations),
        }
        if audit:
            payload["stale_waivers"] = [
                {"file": s.file, "line": s.line, "rules": list(s.rules),
                 "scope": s.scope} for s in stale]
        print(json.dumps(payload, indent=2))
    else:
        for v in violations:
            print(v)
        for s in stale:
            print(s)
        n = len(violations)
        print(f"lint: {n} violation{'s' if n != 1 else ''} in "
              f"{len(targets)} target(s)"
              + (f", {len(stale)} stale waiver(s)" if audit else ""))
    return 1 if violations or stale else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
