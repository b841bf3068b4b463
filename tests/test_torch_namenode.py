"""The port NameNode against the reference on the same op stream.

Each family is a script of ``rpc_*`` calls and monitor ticks run through
``tests/_nn_standin.Twin`` on a reference and a port NameNode (small
sizes: ``block_size`` 1024, replication 3).  Every return value or error,
every heartbeat's commands, every edit-log byte and every fsimage byte
must be equal; at the end each package reopens the OTHER's meta dir
(cross replay) to the same namespace, counters and (after re-reports)
block map, and both continue with the same ops, their logs still equal.
"""

from __future__ import annotations

import pytest

from _nn_standin import Twin

CFG = dict(replication=3, block_size=1024, dead_node_interval_s=6.0,
           heartbeat_interval_s=1.0, flight_interval_s=0.0)


def cmd_names(cmds: dict) -> set[str]:
    return {c["cmd"] for cs in cmds.values() for c in cs}


# ------------------------------------------------------------------ families

def fam_namespace(t: Twin) -> list[str]:
    """Namespace, leases, append, truncate, concat, symlinks."""
    t.register(4)
    t.call("mkdir", path="/a/b/c")
    t.call("mkdir", path="/a/b/c")                      # idempotent
    t.call("listing", path="/a")
    t.call("stat", path="/a/b/c")
    f = t.write_file("/a/f1", [1024, 1024, 300], scheme="dedup_lz4")
    t.call("get_block_locations", path="/a/f1")
    t.call("stat", path="/a/f1")
    # leases: a second writer is refused; renew; a create over a complete
    # file is refused
    t.call("create", path="/a/f2", client="c1", replication=2)
    t.call("add_block", path="/a/f2", client="c2",
           expect_error="PermissionError")
    t.call("create", path="/a/f2", client="c2",
           expect_error="PermissionError")
    t.call("renew_lease", client="c1")
    a = t.call("add_block", path="/a/f2", client="c1")
    t.ibr(a, 100)
    t.call("fsync", path="/a/f2", client="c1", block_id=a["block_id"],
           length=100)
    t.call("stat", path="/a/f2")
    a2 = t.call("add_block", path="/a/f2", client="c1")
    t.call("abandon_block", path="/a/f2", client="c1",
           block_id=a2["block_id"])
    t.call("complete", path="/a/f2", client="c1",
           block_lengths={a["block_id"]: 100})
    t.call("create", path="/a/f1", client="c9",
           expect_error="FileExistsError")
    # append: reopen, rewrite the partial last block under a bumped
    # generation stamp, complete at the new length
    ap = t.call("append", path="/a/f1", client="c3")
    ab = t.call("append_block", path="/a/f1", client="c3")
    assert ab["block_id"] == ap["last_block"]["block_id"]
    t.ibr(ab, 500, gen_stamp=ab["gen_stamp"])
    t.call("stat", path="/a/f1")
    t.call("complete", path="/a/f1", client="c3",
           block_lengths={b: 1024 for b in f[:2]} | {ab["block_id"]: 500})
    t.call("append", path="/a/f1", client="c4")
    t.call("recover_lease", path="/a/f1")
    t.call("stat", path="/a/f1")
    t.call("truncate", path="/a/f2", new_length=40)
    t.call("stat", path="/a/f2")
    # concat
    t.write_file("/a/s1", [1024, 10], scheme="dedup_lz4")
    t.write_file("/a/s2", [1024], scheme="dedup_lz4")
    t.call("concat", dst="/a/f1", srcs=["/a/s1", "/a/s2"])
    t.call("stat", path="/a/f1")
    t.call("listing", path="/a")
    # rename, delete, times, replication
    t.call("rename", src="/a/f2", dst="/a/b/f2")
    t.call("rename", src="/a/b/f2", dst="/a/f1",
           expect_error="FileExistsError")
    t.call("set_times", path="/a/b/f2", mtime=1234.5)
    t.call("set_replication", path="/a/b/f2", replication=3)
    t.call("delete", path="/a/b/c")
    t.call("delete", path="/nope")
    # symlinks
    t.call("create_symlink", link="/lnk", target="/a/b")
    t.call("stat", path="/lnk", expect_error="SymlinkRedirect")
    t.call("listing", path="/lnk/f2", expect_error="SymlinkRedirect")
    t.call("listing", path="/")
    t.call("create_symlink", link="/a/b", target="/x",
           expect_error="FileExistsError")
    # an abandoned writer: the lease expires and the monitor closes it
    t.call("create", path="/a/orphan", client="dead")
    o = t.call("add_block", path="/a/orphan", client="dead")
    t.ibr(o, 77)
    t.advance(3600.0 * 2)
    for dn in t.dns:
        t.heartbeat(dn)
    t.tick()
    t.call("stat", path="/a/orphan")
    return ["/a/f1", "/a/b/f2", "/a/orphan"]


ALICE = ("alice", ["staff"])
BOB = ("bob", ["users"])


def fam_permissions(t: Twin) -> list[str]:
    """Permissions, ACLs, xattrs, as the superuser and as wire callers."""
    t.register(3)
    t.call("mkdir", path="/home/alice")
    t.call("set_owner", path="/home/alice", owner="alice", group="staff")
    t.call("set_permission", path="/home/alice", mode=0o750)
    t.call("create", path="/home/alice/f", client="ca", user=ALICE)
    t.call("create", path="/home/alice/g", client="cb", user=BOB,
           expect_error="PermissionError")
    t.call("listing", path="/home/alice", user=BOB,
           expect_error="PermissionError")
    t.call("set_acl", path="/home/alice", spec="user:bob:r-x", user=ALICE)
    t.call("get_acl", path="/home/alice")
    t.call("listing", path="/home/alice", user=BOB)
    t.call("set_acl", path="/home/alice", spec="user:bob:rwx,mask::r-x",
           user=ALICE)
    t.call("create", path="/home/alice/h", client="cb", user=BOB,
           expect_error="PermissionError")
    t.call("set_acl", path="/home/alice", default_spec="user:carol:rwx",
           user=ALICE)
    t.call("mkdir", path="/home/alice/sub", user=ALICE)
    t.call("get_acl", path="/home/alice/sub")
    t.call("set_acl", path="/home/alice", remove_default=True, user=ALICE)
    t.call("set_acl", path="/home/alice/sub", remove_all=True, user=ALICE)
    t.call("get_acl", path="/home/alice/sub")
    t.call("set_owner", path="/home/alice", owner="bob", user=ALICE,
           expect_error="PermissionError")
    t.call("set_permission", path="/home/alice/f", mode=0o600, user=BOB,
           expect_error="PermissionError")
    t.call("stat", path="/home/alice/f")
    # xattrs
    t.call("set_xattr", path="/home/alice/f", name="user.tag",
           value=b"\x00\x01blue")
    t.call("set_xattr", path="/home/alice/f", name="user.n", value=b"7")
    t.call("set_xattr", path="/home/alice/f", name="trusted.x", value=b"1",
           user=ALICE, expect_error="PermissionError")
    t.call("get_xattrs", path="/home/alice/f")
    t.call("get_xattrs", path="/home/alice/f", names=["user.n"])
    t.call("remove_xattr", path="/home/alice/f", name="user.tag")
    t.call("remove_xattr", path="/home/alice/f", name="user.none")
    t.call("get_xattrs", path="/home/alice/f")
    return []


def fam_snapshots(t: Twin) -> list[str]:
    """Snapshots and diff."""
    t.register(3)
    t.call("mkdir", path="/s/d")
    t.write_file("/s/d/f1", [1024, 5])
    t.call("create_snapshot", path="/s", name="s0",
           expect_error="PermissionError")
    t.call("allow_snapshot", path="/s")
    t.call("create_snapshot", path="/s", name="s0")
    t.write_file("/s/d/f2", [9])
    t.call("rename", src="/s/d/f1", dst="/s/f1r")
    t.call("delete", path="/s/d/f2")
    t.call("create_snapshot", path="/s", name="s1")
    t.call("delete", path="/s/f1r")
    t.call("list_snapshots", path="/s")
    t.call("snapshot_diff", path="/s", from_snap="s0", to_snap="s1")
    t.call("snapshot_diff", path="/s", from_snap="s0")
    t.call("listing", path="/s/.snapshot/s0/d")
    t.call("get_block_locations", path="/s/.snapshot/s0/d/f1")
    t.call("delete_snapshot", path="/s", name="s0")
    t.call("list_snapshots", path="/s")
    t.tick()
    return []


def fam_quotas(t: Twin) -> list[str]:
    """Namespace and space quotas, content summary."""
    t.register(3)
    t.call("mkdir", path="/q")
    t.call("set_quota", path="/q", namespace_quota=3, space_quota=-1)
    t.call("mkdir", path="/q/a")
    t.call("mkdir", path="/q/b")
    t.call("mkdir", path="/q/c", expect_error="OSError")
    t.call("content_summary", path="/q")
    t.call("set_quota", path="/q", namespace_quota=100, space_quota=1500)
    t.call("create", path="/q/a/f", client="c1")
    a = t.call("add_block", path="/q/a/f", client="c1")
    t.call("add_block", path="/q/a/f", client="c1", expect_error="OSError")
    t.ibr(a, 1000)
    t.call("complete", path="/q/a/f", client="c1",
           block_lengths={a["block_id"]: 1000})
    t.call("content_summary", path="/q")
    t.call("content_summary", path="/")
    t.call("set_quota", path="/q", namespace_quota=-1, space_quota=-1)
    return ["/q/a/f"]


def fam_encryption(t: Twin) -> list[str]:
    """Encryption zones: keys and EDEKs from the pinned urandom."""
    t.register(3)
    t.call("create_encryption_key", name="zk1")
    t.call("mkdir", path="/secure")
    t.call("create_encryption_zone", path="/secure", key_name="zk1")
    t.call("mkdir", path="/z2")
    t.call("create_encryption_zone", path="/z2", key_name="nokey",
           expect_error="KeyError")
    t.call("create_encryption_zone", path="/secure", key_name="zk1",
           expect_error="OSError")
    info = t.call("create", path="/secure/f", client="c1")
    assert info["encryption"] is not None
    a = t.call("add_block", path="/secure/f", client="c1")
    t.ibr(a, 333)
    t.call("complete", path="/secure/f", client="c1",
           block_lengths={a["block_id"]: 333})
    t.call("get_ez", path="/secure/f")
    t.call("list_encryption_zones")
    got = t.call("decrypt_edek", path="/secure/f")
    assert got["dek"] == info["encryption"]["dek"]
    t.call("decrypt_edek", path="/secure/f", user=BOB)
    t.call("append", path="/secure/f", client="c2", expect_error="OSError")
    t.call("get_xattrs", path="/secure/f")
    t.call("rename", src="/secure/f", dst="/out", expect_error="OSError")
    return ["/secure/f"]


def fam_cache(t: Twin) -> list[str]:
    """Cache pools and directives -> cache / uncache commands."""
    t.register(3)
    bids = t.write_file("/c/f", [1024, 200])
    t.call("add_cache_pool", name="p1", limit=-1)
    t.call("list_cache_pools")
    did = t.call("add_cache_directive", path="/c/f", pool="p1")
    t.call("add_cache_directive", path="/c/f", pool="nopool",
           expect_error="FileNotFoundError")
    cmds = t.tick()
    assert "cache" in cmd_names(cmds)
    holder = {d: [b for c in cs if c["cmd"] == "cache"
                  for b in c["block_ids"]] for d, cs in cmds.items()}
    stats = {d: {"cached_blocks": b} for d, b in holder.items() if b}
    for d, st in stats.items():
        t.heartbeat(d, st)
    t.call("list_cache_directives")
    t.call("remove_cache_directive", directive_id=did)
    cmds = t.tick(stats)
    assert "uncache" in cmd_names(cmds)
    t.call("remove_cache_pool", name="p1")
    t.call("list_cache_pools")
    assert bids
    return ["/c/f"]


def fam_storage_policy(t: Twin) -> list[str]:
    """Storage policies over DataNodes of several storage types."""
    t.register(2, storage_type="DISK")
    t.register(2, start=2, storage_type="SSD")
    t.register(2, start=4, storage_type="ARCHIVE")
    t.call("mkdir", path="/p/cold")
    t.call("set_storage_policy", path="/p/cold", policy="cold")
    t.call("set_storage_policy", path="/p", policy="bogus",
           expect_error="ValueError")
    t.call("get_storage_policy", path="/p/cold")
    t.call("create", path="/p/cold/f", client="c1")
    a = t.call("add_block", path="/p/cold/f", client="c1")
    t.ibr(a, 100)
    t.call("complete", path="/p/cold/f", client="c1",
           block_lengths={a["block_id"]: 100})
    t.call("set_storage_policy", path="/p", policy="one_ssd")
    t.write_file("/p/f2", [50])
    t.call("get_storage_policy", path="/p/f2")
    t.call("set_storage_policy", path="/p/cold", policy="all_ssd")
    t.call("policy_violations")
    t.tick()
    return ["/p/cold/f", "/p/f2"]


def fam_reports(t: Twin) -> list[str]:
    """Full block reports and IBRs: stale generations, short replicas,
    unknown blocks (-> invalidate), other pools' blocks."""
    t.register(4)
    b1, b2 = t.write_file("/r/f", [1024, 600])
    t.call("block_report", dn_id="dn-3",
           blocks=[[b1, 1, 1024], [b2, 1, 300], [99999, 1, 10],
                   [(5 << 48) | 1, 1, 10], [b1 + 1000, 1, 5, "SSD"]])
    t.heartbeat("dn-3")
    t.call("block_received", dn_id="dn-3", block_id=b2, length=600,
           gen_stamp=0)
    t.call("block_received", dn_id="dn-3", block_id=b2, length=600,
           storage_type="SSD")
    t.call("block_received", dn_id="dn-9", block_id=b2, length=600)
    t.call("block_report", dn_id="dn-9", blocks=[],
           expect_error="KeyError")
    t.call("get_block_locations", path="/r/f")
    t.call("lifeline", dn_id="dn-1")
    t.call("lifeline", dn_id="dn-9")
    t.call("datanode_report")
    t.call("datanode_blocks", dn_id="dn-0")
    rep = t.reports()
    t.call("block_report", dn_id="dn-0", blocks=rep["dn-0"][:1])
    t.call("get_block_locations", path="/r/f")
    t.tick()
    return ["/r/f"]


def fam_dead_replicate(t: Twin) -> list[str]:
    """A DataNode stops heartbeating -> declared dead -> replicate."""
    t.register(4)
    bids = t.write_file("/d/f", [1024, 1024, 10])
    holders = sorted(t.ref._blocks[bids[0]].locations)
    victim = holders[0]
    for _ in range(7):
        t.advance(1.0)
        for d in sorted(t.dns):
            if d != victim:
                t.heartbeat(d)
    cmds = t.tick()
    assert victim not in t.ref._datanodes
    reps = [c for cs in cmds.values() for c in cs if c["cmd"] == "replicate"]
    assert reps
    for c in reps:
        for tg in c["targets"]:
            t.call("block_received", dn_id=tg["dn_id"],
                   block_id=c["block_id"],
                   length=t.ref._blocks[c["block_id"]].length)
    t.tick()
    t.call("cluster_status")
    t.call("fsck")
    return ["/d/f"]


def fam_delete_excess(t: Twin) -> list[str]:
    """Deletes and excess replicas -> invalidate."""
    t.register(4, racks=["/r1", "/r2"])
    b = t.write_file("/x/f", [1024])[0]
    t.write_file("/x/g", [1024, 7])
    t.call("set_replication", path="/x/f", replication=2)
    cmds = t.tick()
    assert "invalidate" in cmd_names(cmds)
    extra = sorted(set(t.dns) - t.ref._blocks[b].locations)
    t.call("block_received", dn_id=extra[0], block_id=b, length=1024)
    t.tick()
    rep = t.reports()
    t.call("delete", path="/x/g")
    for d in sorted(rep):
        t.call("block_report", dn_id=d, blocks=rep[d])
    cmds = t.tick()
    assert "invalidate" in cmd_names(cmds)
    return ["/x/f"]


def fam_decommission(t: Twin) -> list[str]:
    """Decommission, balancer moves, balancer bandwidth, safemode."""
    t.register(5)
    b = t.write_file("/m/f", [1024, 512])
    src = sorted(t.ref._blocks[b[0]].locations)[0]
    t.call("decommission", dn_id=src)
    t.call("decommission", dn_id="dn-9")
    t.call("decommission_status", dn_id=src)
    cmds = t.tick()
    for c in (c for cs in cmds.values() for c in cs
              if c["cmd"] == "replicate"):
        for tg in c["targets"]:
            t.call("block_received", dn_id=tg["dn_id"],
                   block_id=c["block_id"],
                   length=t.ref._blocks[c["block_id"]].length)
    t.call("decommission_status", dn_id=src)
    t.call("recommission", dn_id=src)
    t.call("decommission_status", dn_id=src)
    # balancer move
    locs = sorted(t.ref._blocks[b[1]].locations)
    free = sorted(set(t.dns) - set(locs))[0]
    t.call("move_block", block_id=b[1], from_dn=locs[0], to_dn=free)
    t.call("move_block", block_id=b[1], from_dn=locs[0], to_dn=locs[1])
    t.tick()
    t.call("block_received", dn_id=free, block_id=b[1], length=512)
    cmds = t.tick()
    assert "invalidate" in cmd_names(cmds)
    t.call("set_balancer_bandwidth", bytes_per_s=1 << 20)
    t.tick()
    # safemode
    t.call("safemode", action="enter")
    t.call("mkdir", path="/m/blocked", expect_error="OSError")
    t.call("safemode", action="get")
    t.call("safemode", action="enter", user=BOB,
           expect_error="PermissionError")
    t.call("safemode", action="leave")
    t.call("mkdir", path="/m/ok")
    t.call("bad_block", dn_id=locs[1], block_id=b[1])
    t.tick()
    return ["/m/f"]


def fam_ec_groups(t: Twin) -> list[str]:
    """An EC file's block group loses an internal block ->
    ec_reconstruct."""
    t.register(6)
    t.call("create", path="/e/f", client="c1", ec="rs-3-2-1k")
    t.call("create", path="/e/bad", client="c1", ec="nope",
           expect_error="ValueError")
    g = t.call("add_block_group", path="/e/f", client="c1")
    for blk in g["blocks"]:
        t.call("block_received", dn_id=blk["target"]["dn_id"],
               block_id=blk["block_id"], length=1024)
    t.call("complete", path="/e/f", client="c1",
           block_lengths={g["group_id"]: 3000})
    t.call("get_block_locations", path="/e/f")
    t.call("stat", path="/e/f")
    lost = sorted(t.ref._blocks[g["blocks"][0]["block_id"]].locations)[0]
    for _ in range(7):
        t.advance(1.0)
        for d in sorted(t.dns):
            if d != lost:
                t.heartbeat(d)
    cmds = t.tick()
    assert "ec_reconstruct" in cmd_names(cmds)
    t.call("ec_status")
    t.call("fsck")
    return ["/e/f"]


def _manifest(holders: list, k: int = 3, m: int = 2) -> dict:
    return {"k": k, "m": m, "stripe_len": 64, "length": 150,
            "holders": holders}


def _demote(t: Twin, path: str) -> tuple[int, str, list]:
    """Idle a file past ec_demote_after_s: the monitor schedules
    stripe_demote on the owner; the owner reports stripe_complete."""
    for nn in (t.ref, t.port):
        nn.config.ec_demote_after_s = 30.0
    t.advance(31.0)
    for d in sorted(t.dns):
        if d in t.ref._datanodes:
            t.heartbeat(d)
    cmds = t.tick()
    dem = [(d, c) for d, cs in cmds.items() for c in cs
           if c["cmd"] == "stripe_demote"]
    assert dem, cmds
    owner, c = dem[0]
    holders = [list(x) for x in c["targets"]]
    t.call("stripe_complete", dn_id=owner, block_id=c["block_id"],
           containers=[{"cid": 7, "holders": holders, "logical": 150,
                        "physical": 320, "manifest": _manifest(holders)}])
    return c["block_id"], owner, holders


def fam_ec_demote(t: Twin) -> list[str]:
    """Idle blocks -> stripe_demote; stripe_complete -> invalidate of the
    other full replicas; ec_status counts the demotion."""
    t.register(5)
    t.write_file("/cold/f", [1024, 300], scheme="dedup_lz4")
    bid, owner, holders = _demote(t, "/cold/f")
    for d in sorted(t.ref._datanodes):
        t.heartbeat(d)
    t.call("ec_status")
    t.call("cluster_status")
    t.tick()
    t.tick()
    t.call("get_block_locations", path="/cold/f")
    assert bid in t.ref._ec_demoted
    return ["/cold/f"]


def fam_stripe_repair(t: Twin) -> list[str]:
    """Lost and corrupt stripes -> stripe_repair, owner loss included."""
    t.register(6)
    t.write_file("/cold/f", [1024], scheme="dedup_lz4")
    bid, owner, holders = _demote(t, "/cold/f")
    ec = {"manifests": {"7": {"holders": holders, "length": 150}}}
    t.heartbeat(owner, {"ec": ec})
    # a scrubber-confirmed corrupt stripe on a live holder
    t.call("bad_stripe", dn_id=holders[1][0], owner=owner, cid=7, idx=1)
    cmds = t.tick({owner: {"ec": ec}})
    assert "stripe_repair" in cmd_names(cmds)
    # a non-owner holder dies
    lost = next(h[0] for h in holders if h[0] != owner)
    t.advance(31.0)
    for _ in range(7):
        t.advance(1.0)
        for d in sorted(t.dns):
            if d != lost and d in t.ref._datanodes:
                t.heartbeat(d, {"ec": ec} if d == owner else None)
    cmds = t.tick({owner: {"ec": ec}})
    assert "stripe_repair" in cmd_names(cmds)
    # the owner dies: a surviving holder is deputized with the journaled
    # manifest
    for _ in range(7):
        t.advance(1.0)
        for d in sorted(t.dns):
            if d not in (lost, owner) and d in t.ref._datanodes:
                t.heartbeat(d)
    t.advance(40.0)
    for d in sorted(t.ref._datanodes):
        if d not in (lost, owner):
            t.heartbeat(d)
    cmds = t.tick()
    reps = [c for cs in cmds.values() for c in cs
            if c["cmd"] == "stripe_repair"]
    assert any("manifest" in c for c in reps), cmds
    agent = next(d for d, cs in cmds.items() for c in cs
                 if c["cmd"] == "stripe_repair")
    t.call("stripe_complete", dn_id=agent, block_id=None, owner=owner,
           containers=[{"cid": 7, "holders": holders, "logical": 150,
                        "manifest": _manifest(holders)}])
    t.call("ec_status")
    return ["/cold/f"]


def fam_partial(t: Twin) -> list[str]:
    """Partial (segment) replicas -> replicate upgrade, or mirror_assemble
    when no full replica is left."""
    t.register(5)
    t.call("create", path="/pr/f", client="c1", scheme="dedup_lz4")
    a = t.call("add_block", path="/pr/f", client="c1")
    first = a["targets"][0]["dn_id"]
    t.call("block_received", dn_id=first, block_id=a["block_id"],
           length=800)
    for tg in a["targets"][1:]:
        t.call("block_received", dn_id=tg["dn_id"], block_id=a["block_id"],
               length=300, partial=True)
    t.call("complete", path="/pr/f", client="c1",
           block_lengths={a["block_id"]: 800})
    t.call("cluster_status")
    cmds = t.tick()
    assert "replicate" in cmd_names(cmds)
    up = a["targets"][1]["dn_id"]
    t.call("block_received", dn_id=up, block_id=a["block_id"], length=800)
    t.call("cluster_status")
    # a second block whose only full copy dies -> mirror_assemble
    t.call("create", path="/pr/g", client="c2", scheme="dedup_lz4")
    b = t.call("add_block", path="/pr/g", client="c2")
    full = b["targets"][0]["dn_id"]
    t.call("block_received", dn_id=full, block_id=b["block_id"], length=900)
    for tg in b["targets"][1:]:
        t.call("block_received", dn_id=tg["dn_id"], block_id=b["block_id"],
               length=300, partial=True)
    t.call("complete", path="/pr/g", client="c2",
           block_lengths={b["block_id"]: 900})
    t.call("bad_block", dn_id=full, block_id=b["block_id"])
    cmds = t.tick()
    assert "mirror_assemble" in cmd_names(cmds)
    return ["/pr/f", "/pr/g"]


def fam_lease_recovery(t: Twin) -> list[str]:
    """A writer dies with replicas of different lengths -> recover_block
    to the primary; commit_block_sync closes the file."""
    t.register(4)
    t.call("create", path="/l/f", client="gone")
    a = t.call("add_block", path="/l/f", client="gone")
    for i, tg in enumerate(a["targets"]):
        t.call("block_received", dn_id=tg["dn_id"], block_id=a["block_id"],
               length=100 + 10 * i)
    t.advance(3600.0 * 2)
    for d in sorted(t.dns):
        t.heartbeat(d)
    cmds = t.tick()
    rec = [c for cs in cmds.values() for c in cs
           if c["cmd"] == "recover_block"]
    assert rec, cmds
    c = rec[0]
    t.call("commit_block_sync", path=c["path"], block_id=c["block_id"],
           length=100, dn_ids=[p["dn_id"] for p in c["peers"]],
           gen_stamp=c["gen_stamp"] - 1)
    t.call("commit_block_sync", path=c["path"], block_id=c["block_id"],
           length=100, dn_ids=[p["dn_id"] for p in c["peers"]],
           gen_stamp=c["gen_stamp"])
    t.call("stat", path="/l/f")
    # recover_lease RPC on a second orphan, all replicas agreeing
    t.call("create", path="/l/g", client="gone2")
    b = t.call("add_block", path="/l/g", client="gone2")
    t.ibr(b, 64)
    t.call("recover_lease", path="/l/g")
    t.call("stat", path="/l/g")
    return ["/l/f", "/l/g"]


def fam_tokens_events(t: Twin) -> list[str]:
    """Delegation tokens, events, fsck, ec_status, cluster_status,
    finalize_upgrade."""
    t.register(3)
    tok = t.call("get_delegation_token", renewer="yarn", owner="alice")
    t.call("check_delegation_token", token=tok)
    t.advance(60.0)
    for d in sorted(t.dns):
        t.heartbeat(d)
    t.call("renew_delegation_token", token=tok)
    t.call("renew_delegation_token", token=dict(tok, renewer="x"),
           expect_error="PermissionError")
    t.call("check_delegation_token", token=dict(tok, password=b"\x00" * 32))
    t.call("cancel_delegation_token", token=tok)
    t.call("check_delegation_token", token=tok)
    t.call("get_delegation_token")
    t.write_file("/ev/f", [10])
    t.call("rename", src="/ev/f", dst="/ev/g")
    t.call("set_permission", path="/ev/g", mode=0o600)
    t.call("delete", path="/ev/g")
    t.call("get_events")
    t.call("get_events", since_seq=3, limit=2)
    t.call("fsck")
    t.call("ec_status")
    t.call("cluster_status")
    t.call("ha_state")
    t.call("datanode_report")
    t.call("finalize_upgrade")
    cmds = t.tick()
    assert "finalize_upgrade" in cmd_names(cmds)
    return []


FAMILIES = {
    "namespace": fam_namespace,
    "permissions": fam_permissions,
    "snapshots": fam_snapshots,
    "quotas": fam_quotas,
    "encryption": fam_encryption,
    "cache": fam_cache,
    "storage_policy": fam_storage_policy,
    "reports": fam_reports,
    "dead_replicate": fam_dead_replicate,
    "delete_excess": fam_delete_excess,
    "decommission": fam_decommission,
    "ec_groups": fam_ec_groups,
    "ec_demote": fam_ec_demote,
    "stripe_repair": fam_stripe_repair,
    "partial": fam_partial,
    "lease_recovery": fam_lease_recovery,
    "tokens_events": fam_tokens_events,
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_op_stream_matches_reference(tmp_path, family):
    """The same op stream on both packages: equal replies, equal
    DataNode commands, byte-identical edit log and fsimage, and each
    package replays the other's meta dir."""
    t = Twin(str(tmp_path), **CFG)
    try:
        paths = FAMILIES[family](t)
        t.finish(paths)
    finally:
        t.close()


def test_report_of_a_replica_pending_invalidation(tmp_path):
    """A reference fault the port repairs: ``stripe_complete`` queues the
    invalidation of a demoted block's other replicas; a full block report
    a holder sends before its next heartbeat (the DataNode has not run
    the command yet) must not make that replica a location again.  The
    reference re-adds it, and its monitor then prunes one of the two as
    excess, here the stripe owner's (the fullest node), so no replica
    stays; the port keeps the owner's alone."""
    from _nn_standin import MONITOR_TICK

    t = Twin(str(tmp_path), **CFG)
    try:
        t.register(3)
        bid = t.write_file("/f", [1024], scheme="dedup_lz4")[0]
        holders = sorted(t.ref._blocks[bid].locations)
        _, owner, _ = _demote(t, "/f")
        other = next(d for d in holders if d != owner)
        got = {}
        for side, nn in (("ref", t.ref), ("port", t.port)):
            with t.pinned():
                nn.rpc_block_report(other, [[bid, 1, 1024]])
                after_report = sorted(nn._blocks[bid].locations)
                nn._datanodes[owner].blocks.update({991, 992, 993})
                for name in MONITOR_TICK:
                    getattr(nn, name)()
            owner_cmds = nn._datanodes[owner].commands
            got[side] = (after_report, sorted(nn._blocks[bid].locations),
                         any(c["cmd"] == "invalidate" and bid in c["block_ids"]
                             for c in owner_cmds))
        assert got["ref"] == (sorted([owner, other]), [other], True)
        assert got["port"] == ([owner], [owner], False)
    finally:
        t.close()
