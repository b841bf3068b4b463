"""Storage layout versioning + upgrade/rollback (Storage.java analog) (port of
hdrf_tpu/storage/version.py, whole).

Re-expresses the reference's storage-directory versioning —
``server/common/Storage.java:77`` (VERSION files, layout checks,
upgrade/rollback state machine) and ``BlockPoolSliceStorage``'s
rolling-upgrade trash — for every hdrf_tpu store directory (NameNode meta
dir, DataNode data dir, JournalNode dir):

- Every store dir carries a ``VERSION`` file (``layoutVersion``,
  ``storageType``, ``ctime``) written at creation and checked on load.
- A dir with an OLDER layout is upgraded in place THROUGH a snapshot: the
  current tree is first preserved under ``previous/`` (hardlinks for
  immutable files, copies for mutable ones — the reference's
  doUpgrade hardlink trick), then registered upgraders run one layout step
  at a time, then VERSION is bumped.  A crash mid-upgrade leaves
  ``previous.tmp/`` behind; the next load discards it and re-runs the
  upgrade from the intact current tree.
- ``rollback()`` restores the pre-upgrade tree byte-exactly from
  ``previous/`` (NameNode -rollback analog); ``finalize_upgrade()`` drops
  the snapshot (dfsadmin -finalizeUpgrade).
- A dir with a NEWER layout than this binary refuses to load (the
  reference's "future layout version" IncorrectVersionException) — running
  old code over a new format is how stores get bricked.

Layout history:

- datanode 1: flat ``replicas/ containers/ index/`` under the data dir.
- datanode 2: per-volume roots ``volumes/vol-0/{replicas,containers}``
  (multi-volume DataNodes; the chunk index stays DN-wide at ``index/``).
- namenode 1 / journal 1: initial versioned layouts (the VERSION file
  itself is what the bump from implicit 0 adds).
"""

from __future__ import annotations

import os
import shutil
import time

VERSION_FILE = "VERSION"
PREVIOUS = "previous"
PREVIOUS_TMP = "previous.tmp"
# Present while an upgrade is running (created before the snapshot renames
# into place, removed after the last upgrader + VERSION bump).  Lets a
# restart distinguish a TORN upgrade (flag + previous/ -> auto-rollback and
# retry) from a COMPLETED one awaiting finalize (previous/ without flag ->
# a new upgrade must refuse until finalized, or it would overwrite the
# operator's rollback image with a partially-newer tree).
UPGRADE_FLAG = "upgrade.inprogress"

CURRENT = {"datanode": 2, "namenode": 1, "journal": 1}

# Basenames that are immutable once written (snapshot may hardlink them;
# every mutation path for these writes a NEW file + rename, never in
# place): finalized replica data/meta and sealed containers.
_IMMUTABLE_PREFIXES = ("blk_",)
_IMMUTABLE_SUFFIXES = (".sealed",)


class LayoutError(Exception):
    pass


def read_version(directory: str) -> dict | None:
    p = os.path.join(directory, VERSION_FILE)
    try:
        with open(p, "r", encoding="utf-8") as f:
            out: dict = {}
            for line in f:
                line = line.strip()
                if line and "=" in line:
                    k, v = line.split("=", 1)
                    out[k] = v
            out["layoutVersion"] = int(out.get("layoutVersion", 0))
            return out
    except FileNotFoundError:
        return None


def write_version(directory: str, kind: str, layout: int) -> None:
    tmp = os.path.join(directory, VERSION_FILE + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(f"layoutVersion={layout}\n"
                f"storageType={kind}\n"
                f"ctime={int(time.time())}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, VERSION_FILE))


def _is_immutable(name: str) -> bool:
    return (name.startswith(_IMMUTABLE_PREFIXES)
            and not name.endswith(".tmp")) \
        or name.endswith(_IMMUTABLE_SUFFIXES)


def _snapshot(directory: str) -> None:
    """Preserve the current tree under previous/ (crash-safe: built as
    previous.tmp, renamed when complete)."""
    tmp = os.path.join(directory, PREVIOUS_TMP)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for root, dirs, files in os.walk(directory):
        rel = os.path.relpath(root, directory)
        parts = rel.split(os.sep)
        if parts[0] in (PREVIOUS, PREVIOUS_TMP):
            dirs[:] = []
            continue
        dst_root = os.path.join(tmp, rel) if rel != "." else tmp
        os.makedirs(dst_root, exist_ok=True)
        for name in files:
            if rel == "." and name == UPGRADE_FLAG:
                continue   # transient marker, never part of the image
            src = os.path.join(root, name)
            dst = os.path.join(dst_root, name)
            if _is_immutable(name):
                os.link(src, dst)        # doUpgrade hardlink trick
            else:
                shutil.copy2(src, dst)
    os.replace(tmp, os.path.join(directory, PREVIOUS))


def ensure_layout(directory: str, kind: str, upgraders=None) -> int:
    """Check/create/upgrade ``directory`` to the current layout for
    ``kind``.  ``upgraders`` maps from-layout -> fn(directory) applying
    one layout step.  Returns the layout the dir now has."""
    current = CURRENT[kind]
    os.makedirs(directory, exist_ok=True)
    # discard a torn mid-SNAPSHOT tree; the current tree is intact
    # (upgraders only run after the snapshot renamed into place)
    tmp = os.path.join(directory, PREVIOUS_TMP)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    flag = os.path.join(directory, UPGRADE_FLAG)
    if os.path.exists(flag):
        # crashed mid-UPGRADE.  After the snapshot renamed into place the
        # current tree may be half-migrated, but previous/ is the intact
        # pre-upgrade image — restore it (rollback also clears the flag,
        # which the snapshot excludes) and retry from scratch.  Before the
        # rename, the current tree is untouched: just clear the flag.
        if has_previous(directory):
            rollback(directory)
        if os.path.exists(flag):
            os.unlink(flag)
    v = read_version(directory)
    if v is None:
        entries = [e for e in os.listdir(directory)
                   if e not in (PREVIOUS, PREVIOUS_TMP)]
        if not entries:
            write_version(directory, kind, current)
            return current
        layout = 0          # pre-versioning store: implicit layout 0
    else:
        if v.get("storageType") not in (None, "", kind):
            raise LayoutError(
                f"{directory}: VERSION says storageType="
                f"{v.get('storageType')}, expected {kind}")
        layout = v["layoutVersion"]
    if layout > current:
        raise LayoutError(
            f"{directory}: on-disk layout {layout} is NEWER than this "
            f"binary's {kind} layout {current}; refusing to load "
            "(upgrade the software or roll the store back)")
    if layout == current:
        return current
    if has_previous(directory):
        # a COMPLETED earlier upgrade still awaits finalization; starting
        # another would overwrite the operator's rollback image with a
        # partially-newer tree (Storage.java's "previous upgrade in
        # progress" refusal)
        raise LayoutError(
            f"{directory}: layout {layout} needs an upgrade to {current} "
            "but an unfinalized previous/ snapshot exists — finalize (or "
            "roll back) the earlier upgrade first")
    with open(flag, "w", encoding="utf-8") as f:
        f.write(f"{layout}->{current}\n")
    _snapshot(directory)
    while layout < current:
        fn = (upgraders or {}).get(layout)
        if fn is None:
            raise LayoutError(
                f"{directory}: no upgrader registered for {kind} layout "
                f"{layout} -> {layout + 1}")
        fn(directory)
        layout += 1
        write_version(directory, kind, layout)
    os.unlink(flag)
    return layout


def has_previous(directory: str) -> bool:
    return os.path.isdir(os.path.join(directory, PREVIOUS))


def rollback(directory: str) -> None:
    """Restore the pre-upgrade tree byte-exactly from previous/ (the
    -rollback startup option).  The store must not be open."""
    prev = os.path.join(directory, PREVIOUS)
    if not os.path.isdir(prev):
        raise LayoutError(f"{directory}: no previous/ snapshot to roll "
                          "back to")
    for e in os.listdir(directory):
        if e in (PREVIOUS, PREVIOUS_TMP):
            continue
        p = os.path.join(directory, e)
        shutil.rmtree(p) if os.path.isdir(p) else os.unlink(p)
    for e in os.listdir(prev):
        os.replace(os.path.join(prev, e), os.path.join(directory, e))
    os.rmdir(prev)


def finalize_upgrade(directory: str) -> bool:
    """Drop the previous/ snapshot (dfsadmin -finalizeUpgrade): the
    upgrade becomes permanent, space is reclaimed.  Returns whether a
    snapshot existed."""
    prev = os.path.join(directory, PREVIOUS)
    if os.path.isdir(prev):
        shutil.rmtree(prev)
        return True
    return False


# ------------------------------------------------------------- upgraders

def dn_upgrade_0_to_1(directory: str) -> None:
    """Implicit pre-versioning store -> layout 1: just the VERSION file
    (contents unchanged)."""


def dn_upgrade_1_to_2(directory: str) -> None:
    """Flat replicas/containers -> per-volume layout: everything moves
    under volumes/vol-0/ (the first volume); the chunk index stays DN-wide
    at index/ (chunks are shared across volumes by design)."""
    vol0 = os.path.join(directory, "volumes", "vol-0")
    os.makedirs(vol0, exist_ok=True)
    for sub in ("replicas", "containers"):
        src = os.path.join(directory, sub)
        if os.path.isdir(src):
            os.replace(src, os.path.join(vol0, sub))


DN_UPGRADERS = {0: dn_upgrade_0_to_1, 1: dn_upgrade_1_to_2}

# NN/JN layout 1 is the VERSION file itself over the existing contents.
NN_UPGRADERS = {0: lambda d: None}
JN_UPGRADERS = {0: lambda d: None}
