"""Find-db: the read-only tuned-plan artifact (DESIGN.md §15), the port
of the reference package's ``tuning/find_db.py``.

Once the fleet's workers have measured a wave of jobs, ``export``
compiles the merged plan registry into a single versioned artifact that
serving hosts load at start.  The registry stays the fleet's mutable
working state; the find-db is its immutable, distributable snapshot —
engines opening it never write to it (the file is chmod'd read-only as a
reminder), so engine start stays lookup-only fleet-wide and a bad tuning
run is rolled back by pointing ``REPRO_TORCH_FIND_DB`` at the previous
artifact.

The header carries what a host needs to refuse a stale artifact:

* ``grammar_version`` — a plan's tuning key names grammar points; after
  a grammar bump those points may not exist, so a strict load rejects a
  mismatched artifact (non-strict drops to a warning).
* ``platforms`` — a fingerprint of every platform sectioned in the file
  (``cuda|<device names>|torch=<version>``); a host loads only its own
  platform's section (the registry's platform of its device: the card's
  name), so one artifact serves a heterogeneous fleet.

``export --programs`` ships, where the reference bundles its AOT
program cache, what the port compiles ahead of time: the kernel
libraries ``nvcc`` built under ``build/kernels-<hash>/``
(``kernels/cuda.py``).  A CUDA graph does not outlive its process
(``serve/programs.py``), so there are no programs to ship.  The bundle
carries the same sha256 manifest; :func:`verify_program_bundle` checks
the files and that the bundle's hash names this checkout's build
directory, so a host whose sources differ does not load libraries built
from others.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import stat
import time
from pathlib import Path
from typing import Optional

from repro_torch.resilience import degrade, failpoints

log = logging.getLogger(__name__)

FIND_DB_SCHEMA = 1


def find_db_path() -> Optional[Path]:
    """``REPRO_TORCH_FIND_DB`` (empty/unset -> no artifact attached)."""
    raw = os.environ.get("REPRO_TORCH_FIND_DB", "")
    return Path(raw) if raw else None


def attach(path) -> None:
    """Point this process (and its children) at a find-db artifact —
    the programmatic spelling of ``REPRO_TORCH_FIND_DB=...``; the
    default registry overlays it from its next lookup on."""
    from repro_torch.core import registry
    os.environ["REPRO_TORCH_FIND_DB"] = str(path)
    registry.default().attach_find_db(path)


def platform_fingerprint(platform: str) -> str:
    """What 'same platform' means for plan reuse: ``cuda|<the names of
    the visible cards>|torch=<version>`` for a card's platform,
    ``cpu|cpu|torch=<version>`` for the CPU.  It exists to catch
    artifact/host mismatches a human should see; the registry already
    keys plans per platform."""
    import torch
    if platform == "cpu":
        return f"cpu|cpu|torch={torch.__version__}"
    names = sorted({torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())}
                   if torch.cuda.is_available() else ()) or [platform]
    return f"cuda|{'+'.join(names)}|torch={torch.__version__}"


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def export_find_db(out_path, *, registry=None, platform: Optional[str] = None,
                   measured_only: bool = False) -> dict:
    """Compile the merged plan registry into a find-db artifact.

    Reads through the registry's own snapshot path (load + disk-merge
    under its lock), so concurrent worker flushes are folded in rather
    than clobbered.  ``measured_only`` drops model-ranked plans — a
    conservative artifact of timed winners only.  Returns the header that
    was written."""
    from repro_torch.core import registry as reg_mod
    from repro_torch.kernels.variants.grammar import GRAMMAR_VERSION

    reg = registry if registry is not None else reg_mod.default()
    plans = reg.snapshot_plans()
    sections: dict = {}
    for full_key, plan in plans.items():
        plat, _, problem_key = full_key.partition("/")
        if not problem_key:
            continue
        if platform is not None and plat != platform:
            continue
        if measured_only and plan.chosen_by != "measured":
            continue
        sections.setdefault(plat, {})[problem_key] = plan.to_json()

    platforms = {p: platform_fingerprint(p) for p in sorted(sections)}
    header = {"schema": FIND_DB_SCHEMA,
              "grammar_version": GRAMMAR_VERSION,
              "platforms": platforms,
              "created": time.time(),
              "plan_count": sum(len(s) for s in sections.values()),
              "measured_only": measured_only}
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    blob = {"header": header, "plans": sections}
    tmp = out_path.with_name(out_path.name + f".tmp.{os.getpid()}")
    tmp.write_text(json.dumps(blob, indent=1))
    os.replace(tmp, out_path)
    # read-only: the artifact is a snapshot, never a working file (a
    # re-export to the same path still works: os.replace swaps the inode)
    try:
        out_path.chmod(stat.S_IRUSR | stat.S_IRGRP | stat.S_IROTH)
    except OSError:
        pass
    log.info("find-db: exported %d plans (%d platforms) -> %s",
             header["plan_count"], len(platforms), out_path)
    return header


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------


def read_find_db(path=None, *, device=None, platform: Optional[str] = None,
                 strict: bool = False) -> dict:
    """Decode one platform's plan section: ``{problem_key: Plan}``, the
    platform ``platform`` or else ``device``'s (the registry's platform
    key, ``core/registry.py::platform``; default ``cuda``).

    Non-strict (the registry overlay's mode): any problem — missing or
    unreadable file, schema or grammar mismatch, absent platform section
    — degrades to an empty dict with a warning and a counted
    ``registry.find_db`` degradation, because an engine must start even
    with a stale artifact.  ``strict=True`` (the CLI's ``status`` and
    ``install --check``) raises instead."""
    from repro_torch.core.plan import Plan
    from repro_torch.kernels.variants.grammar import GRAMMAR_VERSION

    path = Path(path) if path is not None else find_db_path()
    if path is None:
        return {}

    def problem(msg: str) -> dict:
        if strict:
            raise ValueError(f"find-db {path}: {msg}")
        log.warning("find-db %s ignored: %s", path, msg)
        degrade.record("registry.find_db", key=str(path),
                       fallback="local-plans", error=msg)
        return {}

    try:
        failpoints.fp("finddb.read")
        blob = json.loads(failpoints.corrupt("finddb.read",
                                             path.read_text()))
    except (OSError, json.JSONDecodeError,
            failpoints.InjectedFault) as e:
        return problem(f"unreadable ({e})")
    if not isinstance(blob, dict):
        return problem(f"not a find-db ({type(blob).__name__})")
    header = blob.get("header", {})
    if header.get("schema") != FIND_DB_SCHEMA:
        return problem(f"schema {header.get('schema')!r} != {FIND_DB_SCHEMA}")
    if header.get("grammar_version") != GRAMMAR_VERSION:
        return problem(f"grammar {header.get('grammar_version')!r} != "
                       f"{GRAMMAR_VERSION} (re-export after a grammar bump)")
    if platform is None:
        from repro_torch.core.registry import platform as platform_of
        platform = platform_of(device if device is not None else "cuda")
    section = blob.get("plans", {}).get(platform)
    if section is None:
        return problem(f"no section for platform {platform!r} "
                       f"(has {sorted(blob.get('plans', {}))})")
    out = {}
    for problem_key, pj in section.items():
        try:
            out[problem_key] = Plan.from_json(pj)
        except (TypeError, KeyError):
            log.warning("find-db %s: undecodable plan for %s skipped",
                        path, problem_key)
    return out


def read_header(path) -> dict:
    """The artifact header alone (for ``status``)."""
    blob = json.loads(Path(path).read_text())
    return blob.get("header", {})


# ---------------------------------------------------------------------------
# the kernel-library bundle
# ---------------------------------------------------------------------------

MANIFEST_NAME = "MANIFEST.json"
BUNDLE_SCHEMA = 1


def export_program_bundle(out_dir, *, src_dir=None) -> dict:
    """Copy the built kernel libraries (``src_dir``, default this
    checkout's ``kernels/cuda.py::_build_dir()``) into ``out_dir`` with a
    manifest: per-file sha256 and bytes, and the build directory's name,
    whose hash keys the sources and flags the libraries were built from.
    Returns the manifest."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.variants.grammar import GRAMMAR_VERSION

    src = Path(src_dir) if src_dir else cuda._build_dir()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = {}
    if src.is_dir():
        for f in sorted(src.glob("*.so")):
            if f.name.startswith("."):
                continue                 # a build in progress
            data = f.read_bytes()
            shutil.copy2(f, out_dir / f.name)
            files[f.name] = {"sha256": hashlib.sha256(data).hexdigest(),
                             "bytes": len(data)}
    manifest = {"schema": BUNDLE_SCHEMA,
                "build_dir": src.name,
                "grammar_version": GRAMMAR_VERSION,
                "created": time.time(),
                "files": files}
    (out_dir / MANIFEST_NAME).write_text(json.dumps(manifest, indent=1))
    log.info("kernel bundle: %d libraries -> %s", len(files), out_dir)
    return manifest


def verify_program_bundle(bundle_dir) -> dict:
    """Check a bundle against its manifest and this checkout: every file
    present with its digest, and the bundle's build directory the one
    this checkout's sources hash to.  Returns ``{"ok": bool, "checked":
    n, "problems": [...]}`` — a receiving host runs this before copying
    the libraries into its ``build/``."""
    from repro_torch.kernels import cuda

    bundle_dir = Path(bundle_dir)
    problems = []
    try:
        manifest = json.loads((bundle_dir / MANIFEST_NAME).read_text())
    except (OSError, json.JSONDecodeError) as e:
        return {"ok": False, "checked": 0,
                "problems": [f"manifest unreadable: {e}"]}
    files = manifest.get("files", {})
    for name, meta in files.items():
        f = bundle_dir / name
        if not f.exists():
            problems.append(f"missing {name}")
            continue
        digest = hashlib.sha256(f.read_bytes()).hexdigest()
        if digest != meta.get("sha256"):
            problems.append(f"digest mismatch {name}")
    if manifest.get("build_dir") != cuda._build_dir().name:
        problems.append("the libraries were built from other sources than "
                        "this checkout's (build directory "
                        f"{manifest.get('build_dir')!r} != "
                        f"{cuda._build_dir().name!r})")
    return {"ok": not problems, "checked": len(files), "problems": problems}
