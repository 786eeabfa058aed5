#!/usr/bin/env python3
"""Generate PARITY_TESTS.md: one row per reference integration test
(tests_aa.rs / tests_cg.rs / tests_ua.rs / tests_bin.rs) and per golden
file, mapped to the repo test(s) that cover it, or marked
`blocked: fixture absent` (.MISSING_LARGE_BLOBS) or `redesigned: <why>`.

Classification rules, in order:
  1. blocked   — the test reads a fixture listed in .MISSING_LARGE_BLOBS
                 (this checkout ships no large binary blobs).
  2. redesigned — `*_multiple_threads` / `*_multiple_threads_*` variants:
                 the reference's thread-count-invariance tier maps to the
                 repo's batch-size/device-count-invariance tests
                 (tests/test_sharding.py, tests/test_parallel.py,
                 __graft_entry__.dryrun_multichip).
  3. covered   — a golden file the reference test asserts against is also
                 asserted by a repo test (matched by file name), or the
                 test name matches an explicit MANUAL entry below.
  4. TODO      — everything else (printed to stderr; the ledger is not
                 considered complete until this list is empty).

Run from the repo root:  python tools/gen_test_ledger.py
"""

import pathlib
import re
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = pathlib.Path("/root/reference")
REF_TESTS = REF / "tests"
FILES = REF_TESTS / "files"

# Explicit mappings for reference tests that assert behavior (errors,
# logs, API semantics) rather than a golden file. Values are repo test
# references ("file::test" or prose starting with "redesigned:").
MANUAL = {}
_manual_path = REPO / "tools" / "test_ledger_manual.py"
if _manual_path.exists():
    namespace = {}
    exec(_manual_path.read_text(), namespace)  # noqa: S102 - repo-local data
    MANUAL = namespace["MANUAL"]


# Missing large fixtures for which this checkout ships an equivalent the
# repo tests consume instead (same frames, split / re-encoded).
SUBSTITUTES = {
    "pcpepg.xtc": "split/pcpepg1..5.xtc",
    "cg.xtc": "split/cg1..5.xtc",
}


def missing_fixtures():
    out = set()
    blob_list = REF / ".MISSING_LARGE_BLOBS"
    if blob_list.exists():
        for token in blob_list.read_text().split():
            if "tests/files/" in token:
                name = token.split("tests/files/")[1]
                if name not in SUBSTITUTES:
                    out.add(name)
    return out


def split_tests(src: str):
    """[(fn_name, body)] for every #[test] function in a Rust test file.
    Block-commented (deprecated) tests are dropped first."""
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
    parts = re.split(r"#\[test\]", src)
    tests = []
    for part in parts[1:]:
        m = re.search(r"fn\s+(\w+)\s*\(", part)
        if not m:
            continue
        # body: until the next #[test] was already cut by split; keep all
        tests.append((m.group(1), part))
    return tests


def files_used(body: str):
    """Fixture files a test body references — following one level of
    indirection through CLI input configs (tests_bin.rs points at
    tests/files/inputs/*.yaml whose trajectory/structure fields name the
    real fixtures)."""
    used = set(re.findall(r"tests/files/([\w./-]+)", body))
    for u in list(used):
        if u.startswith("inputs/") and u.endswith(".yaml"):
            cfg = FILES / u
            if cfg.exists():
                text = cfg.read_text()
                used |= set(re.findall(r"tests/files/([\w./-]+)", text))
                # relative references inside the config
                for token in re.findall(
                        r"[\w./-]+\.(?:xtc|trr|tpr|gro|pdb|pqr|ndx|bnd|"
                        r"lammpstrj)", text):
                    used.add(token.split("tests/files/")[-1].lstrip("./"))
    return used


def repo_sources():
    """{repo test file name: text} for every test-bearing source."""
    sources = list((REPO / "tests").glob("*.py")) + [
        REPO / "__graft_entry__.py"]
    return {p.name: p.read_text() for p in sources}


def repo_mentions(stem: str, sources: dict):
    """Repo test files that reference a golden by stem (word-bounded, so
    'aa_order_basic' does not match 'aa_order_basic_concatenated').
    Per-molecule XVG goldens ('X_POPC.xvg') also match the repo's
    templated form ('X_{mol}.xvg'). Generic short stems ('cuboid',
    'sphere') would match unrelated prose, so they are skipped — those
    goldens need a full-filename or MANUAL entry."""
    if len(stem) < 10:
        return []
    stems = [stem]
    m = re.match(r"(.+)_[A-Z0-9]+$", stem)
    if m:
        stems.append(m.group(1) + "_{mol}")
    out = set()
    for s in stems:
        pat = re.compile(r"(?<![\w])" + re.escape(s) + r"(?![\w])")
        out.update(name for name, text in sources.items()
                   if pat.search(text))
    return sorted(out)


GOLDEN_EXT = (".yaml", ".tab", ".csv", ".xvg", ".dat")


def classify(name, body, missing, sources):
    if name in MANUAL:
        entry = MANUAL[name]
        kind = "redesigned" if entry.startswith("redesigned:") else (
            "blocked" if entry.startswith("blocked:") else "covered")
        return (kind, entry.split(":", 1)[-1].strip()
                if kind != "covered" else entry)
    used = files_used(body)
    goldens = sorted({u.split("/")[-1] for u in used
                      if u.endswith(GOLDEN_EXT)})
    hits = {}
    for g in goldens:
        stem = g.rsplit(".", 1)[0]
        for repo_file in repo_mentions(stem, sources):
            hits.setdefault(repo_file, []).append(g)
    thread_variant = re.search(r"multiple_threads|_threads(_|$)|n_threads",
                               name)
    if hits:
        where = ", ".join(f"{f} ({len(gs)} golden)"
                          for f, gs in sorted(hits.items()))
        if thread_variant:
            where += ("; thread-invariance leg → batch/device invariance "
                      "(tests/test_sharding.py, test_parallel.py)")
        return ("covered", where)
    blocked_by = sorted(u for u in used if u in missing)
    if blocked_by:
        return ("blocked",
                f"fixture absent (.MISSING_LARGE_BLOBS): "
                f"{', '.join(blocked_by)}")
    if thread_variant:
        return ("redesigned",
                "thread-invariance → batch/device invariance "
                "(tests/test_sharding.py, tests/test_parallel.py, "
                "__graft_entry__.dryrun_multichip)")
    return ("TODO", f"uses: {', '.join(sorted(used)) or '(no fixtures)'}")


def golden_ledger(missing, sources, golden_status):
    """Rows for every golden file shipped in tests/files. `golden_status`
    maps a golden base name → set of classification statuses of the
    reference tests asserting it (a golden whose every consumer is blocked
    is itself blocked)."""
    rows = []
    for path in sorted(FILES.rglob("*")):
        if not path.is_file() or path.suffix not in GOLDEN_EXT:
            continue
        rel = path.relative_to(FILES).as_posix()
        stem = path.name.rsplit(".", 1)[0]
        repo_files = repo_mentions(stem, sources)
        if not repo_files and "/" in rel:
            # directory-level assertions (e.g. the ordermaps golden tree is
            # swept by directory)
            repo_files = [f + " (directory sweep)" for f in repo_mentions(
                rel.split("/")[0], sources)]
        statuses = golden_status.get(path.name, set())
        if rel.startswith("ordermaps/") and any(
                '(fixtures / "ordermaps").glob' in t
                for t in sources.values()):
            rows.append((rel, "asserted",
                         "test_golden_sweep.py "
                         "test_aa_ordermaps_basic_and_leaflets (full "
                         "directory glob sweep)"))
            continue
        if rel.startswith("inputs/"):
            rows.append((rel, "asserted",
                         "test_config_fixtures.py (inputs/ sweep: parse "
                         "accept/reject parity) + the CLI/runtime tests "
                         "consuming it"))
            continue
        if repo_files:
            rows.append((rel, "asserted", ", ".join(repo_files)))
        elif rel in MANUAL:
            entry = MANUAL[rel]
            kind = "blocked" if entry.startswith("blocked:") else "asserted"
            rows.append((rel, kind, entry.split(":", 1)[-1].strip()
                         if kind == "blocked" else entry))
        elif statuses and statuses <= {"blocked"}:
            rows.append((rel, "blocked",
                         "every reference test asserting it is blocked "
                         "(fixture absent)"))
        else:
            rows.append((rel, "TODO", "no repo assertion"))
    return rows


def validate_manual(sources):
    """Every 'tests/<file>.py::test_x' reference in MANUAL must exist."""
    bad = []
    for key, entry in MANUAL.items():
        for m in re.finditer(r"tests/(\w+\.py)::(\w+)", entry):
            fname, tname = m.group(1), m.group(2)
            text = sources.get(fname, "")
            if not re.search(r"def " + re.escape(tname) + r"\b", text):
                bad.append(f"{key} -> {fname}::{tname}")
    if bad:
        raise SystemExit("MANUAL references nonexistent tests:\n  "
                         + "\n  ".join(bad))


def main():
    missing = missing_fixtures()
    sources = repo_sources()
    validate_manual(sources)

    out = ["# PARITY_TESTS — reference-test ledger",
           "",
           "Generated by `tools/gen_test_ledger.py`. One row per reference",
           "integration test and per golden file. `covered` = a repo test",
           "asserts the same golden output (or the listed behavior);",
           "`redesigned` = the reference mechanism does not exist in the",
           "batched-device architecture and the listed equivalent invariant is tested",
           "instead; `blocked` = the required binary fixture is absent from",
           "this checkout (/root/reference/.MISSING_LARGE_BLOBS).",
           ""]
    stats = {}
    todo = []
    golden_status = {}
    for rs in ("tests_aa.rs", "tests_cg.rs", "tests_ua.rs", "tests_bin.rs"):
        src = (REF_TESTS / rs).read_text()
        tests = split_tests(src)
        out += [f"## {rs} ({len(tests)} tests)", "",
                "| reference test | status | repo coverage |",
                "|---|---|---|"]
        for name, body in tests:
            status, detail = classify(name, body, missing, sources)
            stats[status] = stats.get(status, 0) + 1
            for u in files_used(body):
                if u.endswith(GOLDEN_EXT):
                    golden_status.setdefault(u.split("/")[-1],
                                             set()).add(status)
            if status == "TODO":
                todo.append(f"{rs}::{name}  [{detail}]")
            out.append(f"| {name} | {status} | {detail} |")
        out.append("")

    rows = golden_ledger(missing, sources, golden_status)
    n_ok = sum(1 for r in rows if r[1] == "asserted")
    out += [f"## Golden files ({len(rows)} total, {n_ok} asserted)", "",
            "| golden file | status | asserted by |",
            "|---|---|---|"]
    for rel, status, detail in rows:
        if status == "TODO":
            stats["golden-TODO"] = stats.get("golden-TODO", 0) + 1
            todo.append(f"golden::{rel}")
        out.append(f"| {rel} | {status} | {detail} |")
    out += ["", f"## Totals: {stats}", ""]

    (REPO / "PARITY_TESTS.md").write_text("\n".join(out))
    print(f"PARITY_TESTS.md written; totals: {stats}", file=sys.stderr)
    if todo:
        print(f"\n{len(todo)} unclassified:", file=sys.stderr)
        for t in todo:
            print(f"  {t}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
