"""Permission model: owner/group/mode, POSIX ACLs, caller context (port of
hdrf_tpu/server/permissions.py, whole; proto/rpc.RpcServer sets the
caller here).

Re-expression of the reference's permission plane:

- ``FSPermissionChecker.java:49`` (681 LoC) — per-call checker walking the
  inode chain: EXECUTE on every ancestor, the requested access on the
  target, owner/superuser for attribute changes.
- ``AclStorage.java:65`` / ``FSDirAclOp.java`` — POSIX-draft ACLs: named
  user/group entries masked by the mask entry, plus DEFAULT entries on
  directories that seed their children's access ACLs.
- ``UserGroupInformation`` — the caller identity; here a per-thread call
  context populated by the RPC layer from ``_user``/``_groups`` kwargs
  (the wire is the trust boundary, as with the reference's SASL-backed
  UGI).  In-process callers carry no identity and act as the superuser —
  matching the reference, where the NN's own threads bypass checking.

Permissions are evaluated the HDFS way: the superuser (the NN process
owner) bypasses everything; otherwise owner bits, then named-user entries
(& mask), then owner-group + named-group entries (& mask, any grant wins),
then other bits.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

READ, WRITE, EXECUTE = 4, 2, 1


@dataclass
class Attrs:
    """Inode security attributes (INodeAttributes analog)."""

    owner: str
    group: str
    mode: int
    # Access ACL: list of [kind, name, perm] with kind in
    # ("user", "group", "mask", "other"); name == "" refers to the owner
    # entry ("user::perm") / owner group ("group::perm").
    acl: list = field(default_factory=list)
    # Default ACL (directories only): entries new children inherit.
    dacl: list = field(default_factory=list)
    xattrs: dict = field(default_factory=dict)  # name -> bytes
    # Storage policy name (hot/warm/cold/all_ssd/one_ssd) or None =
    # inherit from the nearest ancestor (BlockStoragePolicySuite analog —
    # the reference stores the policy id in the inode header).
    policy: str | None = None

    def pack(self) -> list:
        return [self.owner, self.group, self.mode, self.acl, self.dacl,
                {k: bytes(v) for k, v in self.xattrs.items()}, self.policy]

    @staticmethod
    def unpack(v: list | None, owner="hdrf", group="supergroup",
               mode=0o755) -> "Attrs":
        if not v:
            return Attrs(owner, group, mode)
        return Attrs(v[0], v[1], v[2], [list(e) for e in v[3]],
                     [list(e) for e in v[4]], dict(v[5]),
                     v[6] if len(v) > 6 else None)


class DirNode(dict):
    """Directory inode: a dict of children + security attributes.  Keeps
    ``isinstance(node, dict)`` true everywhere the namespace walks."""

    def __init__(self, *a, attrs: Attrs | None = None,
                 inode_id: int = 0, **kw):
        super().__init__(*a, **kw)
        self.attrs = attrs or Attrs("hdrf", "supergroup", 0o755)
        self.inode_id = inode_id  # stable identity for snapshot diff


_CTX = threading.local()


def set_caller(user: str | None, groups: list[str] | None) -> None:
    _CTX.user = user
    _CTX.groups = list(groups or [])


def caller() -> tuple[str | None, list[str]]:
    return getattr(_CTX, "user", None), getattr(_CTX, "groups", [])


def effective_entries(attrs: Attrs):
    """(named_users, named_groups, mask) from the access ACL."""
    named_u: dict[str, int] = {}
    named_g: dict[str, int] = {}
    mask = None
    for kind, name, perm in attrs.acl:
        if kind == "user" and name:
            named_u[name] = perm
        elif kind == "group" and name:
            named_g[name] = perm
        elif kind == "mask":
            mask = perm
    if mask is None and (named_u or named_g):
        mask = (attrs.mode >> 3) & 7
    return named_u, named_g, mask


def allows(attrs: Attrs, user: str, groups: list[str], want: int) -> bool:
    """The FSPermissionChecker access algorithm for one inode."""
    if user == attrs.owner:
        return (attrs.mode >> 6) & want == want
    named_u, named_g, mask = effective_entries(attrs)
    if user in named_u:
        perm = named_u[user] if mask is None else named_u[user] & mask
        return perm & want == want
    in_group = attrs.group in groups or attrs.group == user
    grp_perm = (attrs.mode >> 3) & 7
    candidates = []
    if in_group:
        candidates.append(grp_perm if mask is None else grp_perm & mask)
    for g, p in named_g.items():
        if g in groups:
            candidates.append(p if mask is None else p & mask)
    if candidates:  # any granting entry wins (POSIX ACL group class)
        return any(c & want == want for c in candidates)
    return attrs.mode & want == want


def inherit_attrs(parent: Attrs, user: str, group: str | None,
                  is_dir: bool, umode: int | None = None) -> Attrs:
    """Attributes for a new child: owner = caller, group = parent's group
    (BSD semantics, what HDFS does), default ACL of the parent becomes the
    child's access ACL (and default ACL again for directories)."""
    mode = umode if umode is not None else (0o755 if is_dir else 0o644)
    acl = [list(e) for e in parent.dacl]
    dacl = [list(e) for e in parent.dacl] if is_dir else []
    group = group or parent.group
    return Attrs(user, group, mode, acl, dacl)


def acl_spec_parse(spec: str) -> list:
    """'user:alice:rwx,group::r-x,mask::rw-' -> entries.  The setfacl
    format (minus default: prefix, which callers split off)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) != 3:
            raise ValueError(f"bad ACL entry {part!r}")
        kind, name, p = bits
        if kind not in ("user", "group", "mask", "other"):
            raise ValueError(f"bad ACL kind {kind!r}")
        perm = 0
        for ch, v in (("r", READ), ("w", WRITE), ("x", EXECUTE)):
            if ch in p:
                perm |= v
        out.append([kind, name, perm])
    return out


def acl_to_strings(attrs: Attrs) -> list[str]:
    def fmt(perm):
        return "".join(c if perm & v else "-"
                       for c, v in (("r", 4), ("w", 2), ("x", 1)))

    out = [f"user::{fmt((attrs.mode >> 6) & 7)}"]
    for kind, name, perm in attrs.acl:
        if kind in ("user", "group") and name:
            out.append(f"{kind}:{name}:{fmt(perm)}")
    out.append(f"group::{fmt((attrs.mode >> 3) & 7)}")
    _, _, mask = effective_entries(attrs)
    if mask is not None:
        out.append(f"mask::{fmt(mask)}")
    out.append(f"other::{fmt(attrs.mode & 7)}")
    for kind, name, perm in attrs.dacl:
        out.append(f"default:{kind}:{name}:{fmt(perm)}")
    return out
