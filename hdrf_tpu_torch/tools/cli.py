"""Command-line tools: the reference's shell surface re-expressed (port of
hdrf_tpu/tools/cli.py ``main``; the same subcommands and output, plus
``--device cuda|cpu`` on the client commands and ``httpfs``: where the
client's striped path runs its RS kernel, the card unless asked).

One entry point (``python -m hdrf_tpu_torch.tools.cli``) with subcommands mirroring
the reference's launcher + admin tools (``src/main/bin/hdfs`` subcommand
dispatch; DFSAdmin.java:441, OfflineImageViewer / OfflineEditsViewer under
``hdfs/tools/``; Balancer under ``server/balancer/``):

  namenode / datanode      daemon launchers
  httpfs                   WebHDFS-style HTTP gateway
  dfs                      -ls -mkdir -put -get -cat -rm -mv -stat -du -count
                           -createSnapshot -deleteSnapshot -lsSnapshots
                           -snapshotDiff -checksum
                           -chmod -chown -getfacl -setfacl -setfattr -getfattr
  mover                    migrate replicas to satisfy storage policies
  dfsadmin                 -report -savenamespace -metrics -slowPeers
                           -contention -ecStatus -fsck
                           -movblock -setBalancerBandwidth -provide
                           -allowSnapshot -setQuota -setSpaceQuota -clrQuota
                           -safemode -decommission -decommissionStatus
                           -haState -haStatus -transitionToActive
  oiv / oev                offline fsimage / edit-log viewers
  balancer                 spread replicas toward the mean DN utilization
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _addr(s: str) -> tuple[str, int]:
    host, port = s.rsplit(":", 1)
    return host, int(port)


def _client(args):
    from hdrf_tpu_torch.client.filesystem import HdrfClient
    from hdrf_tpu_torch.config import ClientConfig

    # --secure (or HDRF_SECURE=1): fetch a delegation token and encrypt the
    # data wire — required against require_token_auth/encrypted clusters.
    secure = bool(getattr(args, "secure", False) or
                  os.environ.get("HDRF_SECURE"))
    cfg = ClientConfig(use_delegation_tokens=secure,
                       encrypt_data_transfer=secure)
    return HdrfClient(_addr(args.namenode), config=cfg,
                      device=getattr(args, "device", "cuda"))


# ------------------------------------------------------------------- daemons

def cmd_namenode(args) -> int:
    from hdrf_tpu_torch.config import HdrfConfig
    from hdrf_tpu_torch.server.namenode import NameNode

    cfg = HdrfConfig.load(args.config)
    if args.port is not None:
        cfg.namenode.port = args.port
    nn = NameNode(cfg.namenode).start()
    # daemon banners go to STDOUT via the structured logger (tooling greps
    # the "listening on host:port" substring, kept in both log formats)
    from hdrf_tpu_torch.utils import log

    log.get_logger("namenode", stream=sys.stdout).info(
        f"namenode listening on {nn.addr[0]}:{nn.addr[1]}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        nn.stop()
    return 0


def cmd_datanode(args) -> int:
    from hdrf_tpu_torch.config import HdrfConfig
    from hdrf_tpu_torch.server.datanode import DataNode

    cfg = HdrfConfig.load(args.config)
    if args.data_dir:
        cfg.datanode.data_dir = args.data_dir
    dn = DataNode(cfg.datanode, _addr(args.namenode)).start()
    from hdrf_tpu_torch.utils import log

    log.get_logger("datanode", stream=sys.stdout).info(
        f"datanode {dn.dn_id} listening on {dn.addr[0]}:{dn.addr[1]}",
        dn_id=dn.dn_id)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        dn.stop()
    return 0


def cmd_httpfs(args) -> int:
    from hdrf_tpu_torch.server.http_gateway import HttpGateway

    gw = HttpGateway(_addr(args.namenode), port=args.port,
                     device=args.device).start()
    from hdrf_tpu_torch.utils import log

    log.get_logger("http_gateway", stream=sys.stdout).info(
        f"http gateway on http://{gw.addr[0]}:{gw.addr[1]}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        gw.stop()
    return 0


# ----------------------------------------------------------------------- dfs

def cmd_dfs(args) -> int:
    with _client(args) as c:
        if args.op == "-ls":
            for e in c.ls(args.args[0] if args.args else "/"):
                kind = "d" if e["type"] == "dir" else "-"
                size = e.get("length", e.get("children", 0))
                print(f"{kind} {size:>12} {e['name']}")
        elif args.op == "-mkdir":
            c.mkdir(args.args[0])
        elif args.op == "-put":
            local, remote = args.args
            with open(local, "rb") as f:
                c.write(remote, f.read(), scheme=args.scheme, ec=args.ec)
        elif args.op == "-get":
            remote, local = args.args
            data = c.read(remote)
            with open(local, "wb") as f:
                f.write(data)
        elif args.op == "-cat":
            sys.stdout.buffer.write(c.read(args.args[0]))
        elif args.op == "-rm":
            paths = [a for a in args.args if a != "-skipTrash"]
            if not paths:
                print("usage: -rm [-skipTrash] <path>", file=sys.stderr)
                return 1
            ok = c.delete(paths[0], skip_trash="-skipTrash" in args.args)
            if not ok:
                print(f"no such path: {paths[0]}", file=sys.stderr)
                return 1
        elif args.op == "-expunge":
            print(f"removed {c.expunge()} trash entries")
        elif args.op == "-mv":
            c.rename(args.args[0], args.args[1])
        elif args.op == "-stat":
            print(json.dumps(c.stat(args.args[0]), indent=2))
        elif args.op == "-du":
            total = sum(e.get("length", 0) for e in c.ls(args.args[0])
                        if e["type"] == "file")
            print(total)
        elif args.op == "-count":
            s = c.content_summary(args.args[0])
            print(f"{s['dirs']} {s['files']} {s['length']} {args.args[0]}")
        elif args.op == "-createSnapshot":
            c.create_snapshot(args.args[0], args.args[1])
        elif args.op == "-deleteSnapshot":
            c.delete_snapshot(args.args[0], args.args[1])
        elif args.op == "-lsSnapshots":
            for name in c.list_snapshots(args.args[0]):
                print(name)
        elif args.op == "-checksum":
            fc = c.get_file_checksum(args.args[0])
            print(f"{args.args[0]}\t{fc['algorithm']}\t{fc['bytes']}")
        elif args.op == "-snapshotDiff":
            # <root> <from> <to>; "." for <to> = the current tree
            root, frm, to = args.args[0], args.args[1], args.args[2]
            rep = c.snapshot_diff(root, frm, "" if to == "." else to)
            marks = {"CREATE": "+", "DELETE": "-", "MODIFY": "M",
                     "RENAME": "R"}
            for e in rep["entries"]:
                line = f"{marks[e['type']]}\t{e['path']}"
                if e["type"] == "RENAME":
                    line += f" -> {e['target']}"
                print(line)
        elif args.op == "-chmod":
            c.chmod(args.args[1], int(args.args[0], 8))
        elif args.op == "-chown":
            spec, path = args.args
            owner, _, group = spec.partition(":")
            c.chown(path, owner=owner, group=group)
        elif args.op == "-getfacl":
            for line in c.getfacl(args.args[0])["entries"]:
                print(line)
        elif args.op == "-setfacl":
            # -setfacl [-b | -k] <path> | -setfacl -m <spec> <path>
            if args.args[0] == "-b":
                c.setfacl(args.args[1], remove_all=True)
            elif args.args[0] == "-k":
                c.setfacl(args.args[1], remove_default=True)
            else:
                spec = args.args[1] if args.args[0] == "-m" else args.args[0]
                path = args.args[-1]
                acc = ",".join(e for e in spec.split(",")
                               if not e.startswith("default:"))
                dfl = ",".join(e[len("default:"):]
                               for e in spec.split(",")
                               if e.startswith("default:"))
                c.setfacl(path, spec=acc, default_spec=dfl)
        elif args.op == "-setfattr":
            # -setfattr -n name [-v value] <path> | -setfattr -x name <path>
            if args.args[0] == "-x":
                c.removefattr(args.args[2], args.args[1])
            else:
                name = args.args[1]
                if "-v" in args.args:
                    v = args.args[args.args.index("-v") + 1].encode()
                else:
                    v = b""
                c.setfattr(args.args[-1], name, v)
        elif args.op == "-getfattr":
            for k, v in sorted(c.getfattr(args.args[0]).items()):
                print(f"{k}={v.decode(errors='replace')}")
        else:
            print(f"unknown dfs op {args.op}", file=sys.stderr)
            return 1
    return 0


# ------------------------------------------------------------------ dfsadmin

def _dn_call(addr: str, op: str, timeout: float = 30.0, **fields) -> dict:
    """One data-plane op against a DataNode ('host:port') — the direct
    path dfsadmin -reconfig and diskbalancer share."""
    import socket as _socket

    from hdrf_tpu_torch.proto import datatransfer as dt
    from hdrf_tpu_torch.proto.rpc import recv_frame

    host, port = addr.rsplit(":", 1)
    with _socket.create_connection((host, int(port)), timeout=timeout) as s:
        dt.send_op(s, op, **fields)
        return recv_frame(s)


def cmd_dfsadmin(args) -> int:
    if args.op == "-reconfig":
        # DataNode-direct (ReconfigurationProtocol analog): no NN
        # round trip — reconfiguring a DN must work while the NN is down
        if args.args[1] == "list":
            print(json.dumps(_dn_call(args.args[0], "get_reconfigurable")))
        else:
            print(json.dumps(_dn_call(args.args[0], "reconfigure",
                                      key=args.args[1],
                                      value=args.args[2])))
        return 0
    with _client(args) as c:
        if args.op == "-report":
            # cluster summary first (dfsadmin -report's header block).
            # dedup_ratio prints with repr fidelity: operators (and the
            # acceptance test) compare it exactly against the ratio
            # recomputed from the chunk index.
            cs = c._call("cluster_status")
            print(f"Cluster: up={cs['live']} down={cs['dead']} "
                  f"blocks={cs['blocks']} "
                  f"under_replicated={cs['under_replicated']} "
                  f"safemode={cs['safemode']}")
            print(f"Reduction: dedup_ratio={cs['dedup_ratio']!r} "
                  f"dedup_logical={cs['dedup_logical_bytes']} "
                  f"dedup_unique={cs['dedup_unique_bytes']}")
            print(f"Health: slow_peers={cs['slow_peers']} "
                  f"slow_volumes={cs['slow_volumes']} "
                  f"reduction_degraded={cs.get('reduction_degraded', 0)}")
            for d in c.datanode_report():
                state = "live" if d["alive"] else "dead"
                stats = d.get("stats", {})
                stalls = stats.get("stalls", 0)
                vols = stats.get("volumes") or {}
                failed = sum(1 for v in vols.values() if v.get("failed"))
                # passthrough marker: the DN's worker breaker is open —
                # writes land unreduced until the half-open probe re-closes
                degraded = (" REDUCTION_DEGRADED"
                            if stats.get("reduction_degraded") else "")
                print(f"{d['dn_id']:>12} {state:>5} blocks={d['blocks']} "
                      f"logical={stats.get('logical_bytes', 0)} "
                      f"physical={stats.get('physical_bytes', 0)} "
                      f"volumes={len(vols)} failed_volumes={failed} "
                      f"stalls={stalls}{degraded}")
        elif args.op == "-savenamespace":
            c._call("save_namespace")
            print("namespace saved")
        elif args.op == "-metrics":
            print(json.dumps(c._call("metrics"), indent=2, sort_keys=True))
        elif args.op == "-slowPeers":
            # the outlier detector's verdict (slow_nodes_report) — peers
            # AND volumes, with the medians they were judged against
            print(json.dumps(c._call("slow_nodes_report"), indent=2))
        elif args.op == "-contention":
            # control-plane contention observatory: per-method
            # RPC service table + the namesystem lock's wait/hold books
            print(json.dumps(c._call("contention"), indent=2,
                             sort_keys=True))
        elif args.op == "-ecStatus":
            # cold-tier census: striped vs replicated containers and the
            # stripe tier's physical/logical ratio vs replication
            es = c._call("ec_status")
            print(f"EC policy: {es['policy']} "
                  f"(demote_after_s={es['demote_after_s']})")
            print(f"Demoted blocks: {es['demoted_blocks']} "
                  f"(pending_demotions={es['pending_demotions']} "
                  f"pending_stripe_repairs={es['pending_stripe_repairs']})")
            print(f"Containers: striped={es['striped_containers']} "
                  f"replicated={es['replicated_containers']} "
                  f"stripe_groups={es['stripe_groups']}")
            print(f"Stripe tier: logical={es['stripe_logical_bytes']} "
                  f"physical={es['stripe_physical_bytes']} "
                  f"ratio={es['storage_ratio_striped']:.2f}x "
                  f"(replicated tier: "
                  f"{es['storage_ratio_replicated']:.1f}x)")
        elif args.op == "-fsck":
            # invariant census (NamenodeFsck analog): block map vs live
            # DN membership, reported lengths, stripe decodability —
            # JSON verdict with per-class violation ids
            print(json.dumps(c._call("fsck"), indent=2, sort_keys=True))
        elif args.op == "-finalizeUpgrade":
            r = c._call("finalize_upgrade")
            print(f"finalized: namenode={r['namenode_finalized']} "
                  f"datanodes_queued={r['datanodes_queued']}")
        elif args.op == "-allowSnapshot":
            c.allow_snapshot(args.args[0])
            print(f"snapshots enabled on {args.args[0]}")
        elif args.op == "-setQuota":
            c.set_quota(args.args[1], namespace_quota=int(args.args[0]))
        elif args.op == "-setSpaceQuota":
            c.set_quota(args.args[1], space_quota=int(args.args[0]))
        elif args.op == "-clrQuota":
            c.set_quota(args.args[0])
        elif args.op == "-provide":
            # mount an external file as a PROVIDED-storage HDFS file:
            # NN registers the namespace half, then every live DN gets
            # the FileRegions (aliasmap/InMemoryAliasMapProtocol's
            # write half over the DN op)
            local, hpath = args.args
            local = os.path.abspath(local)
            length = os.path.getsize(local)
            out = c._call("provide_file", path=hpath,
                          uri=f"file://{local}", length=length)
            pushed = 0
            for d in c.datanode_report():
                if not d["alive"]:
                    continue
                addr = f"{d['addr'][0]}:{d['addr'][1]}"
                try:
                    r = _dn_call(addr, "alias_add",
                                 regions=out["regions"],
                                 tokens=out.get("tokens"))
                    pushed += 1 if r.get("ok") else 0
                except (OSError, ConnectionError) as e:
                    # a DN that died since its last heartbeat must not
                    # abort the mount mid-push; the rest keep serving
                    print(f"  warning: {d['dn_id']} unreachable ({e})",
                          file=sys.stderr)
            print(f"provided {hpath} ({length} bytes, "
                  f"{len(out['regions'])} regions) on {pushed} datanodes")
        elif args.op == "-setBalancerBandwidth":
            n = c._call("set_balancer_bandwidth",
                        bytes_per_s=int(args.args[0]))
            print(f"bandwidth {args.args[0]} B/s queued to {n} datanodes")
        elif args.op == "-recoverLease":
            ok = c._call("recover_lease", path=args.args[0])
            print("recovered" if ok else "not recovered")
        elif args.op == "-safemode":
            mode = args.args[0] if args.args else "get"
            on = c._call("safemode", action=mode)
            print(f"Safe mode is {'ON' if on else 'OFF'}")
        elif args.op == "-decommission":
            ok = c._call("decommission", dn_id=args.args[0])
            print("decommissioning" if ok else "unknown datanode")
            return 0 if ok else 1
        elif args.op == "-recommission":
            ok = c._call("recommission", dn_id=args.args[0])
            print("recommissioned" if ok else "was not decommissioning")
        elif args.op == "-decommissionStatus":
            st = c._call("decommission_status", dn_id=args.args[0])
            print(f"{args.args[0]}: {st['state']} remaining={st['remaining']}")
        elif args.op == "-haState":
            from hdrf_tpu_torch.proto.rpc import RpcClient
            for a in args.args or [args.namenode]:
                host, port = a.rsplit(":", 1)
                try:
                    with RpcClient((host, int(port)), timeout=3.0) as rc:
                        st = rc.call("ha_state")
                    print(f"{a}: {st['role']} seq={st['seq']} epoch={st['epoch']}")
                except (OSError, ConnectionError):
                    print(f"{a}: unreachable")
        elif args.op == "-haStatus":
            # observer-aware -haState (haadmin -getAllServiceState
            # analog): role + applied txid + tail lag per endpoint
            from hdrf_tpu_torch.proto.rpc import RpcClient
            for a in args.args or [args.namenode]:
                host, port = a.rsplit(":", 1)
                try:
                    with RpcClient((host, int(port)), timeout=3.0) as rc:
                        st = rc.call("ha_state")
                    print(f"{a}: {st['role']} "
                          f"applied_txid={st.get('applied_txid', st['seq'])} "
                          f"lag_s={st.get('lag_s', 0.0)} "
                          f"epoch={st['epoch']}")
                except (OSError, ConnectionError):
                    print(f"{a}: unreachable")
        elif args.op == "-transitionToActive":
            from hdrf_tpu_torch.proto.rpc import RpcClient
            host, port = args.args[0].rsplit(":", 1)
            with RpcClient((host, int(port))) as rc:
                rc.call("transition_to_active")
            print("transitioned")
        elif args.op == "-movblock":
            bid, src, dst = args.args
            ok = c._call("move_block", block_id=int(bid), from_dn=src,
                            to_dn=dst)
            print("scheduled" if ok else "rejected")
            return 0 if ok else 1
        else:
            print(f"unknown dfsadmin op {args.op}", file=sys.stderr)
            return 1
    return 0


# ------------------------------------------------------------------- oiv/oev

def cmd_storage(args) -> int:
    """Offline storage-dir maintenance (Storage.java state machine): show
    the VERSION file, roll a store back to its pre-upgrade snapshot
    (namenode -rollback analog), or finalize (drop the snapshot).  The
    daemon owning the dir must be stopped."""
    from hdrf_tpu_torch.storage import version as storage_version

    if args.action == "version":
        v = storage_version.read_version(args.directory)
        print(json.dumps(v if v is not None
                         else {"layoutVersion": 0, "unversioned": True}))
    elif args.action == "rollback":
        storage_version.rollback(args.directory)
        print(f"rolled back {args.directory}")
    elif args.action == "finalize":
        had = storage_version.finalize_upgrade(args.directory)
        print("finalized" if had else "nothing to finalize")
    return 0


def cmd_oiv(args) -> int:
    """Offline image viewer: dump the fsimage namespace as JSON lines
    (OfflineImageViewerPB analog)."""
    from hdrf_tpu_torch.server.editlog import EditLog

    log = EditLog(args.meta_dir)
    snap = log.load_image()
    if snap is None:
        print("no fsimage", file=sys.stderr)
        return 1

    def walk(tree: dict, prefix: str):
        for name, v in sorted(tree.items()):
            path = f"{prefix}/{name}"
            if v[0] == "f":
                print(json.dumps({
                    "path": path, "type": "file", "replication": v[1],
                    "scheme": v[2], "blocks": v[3], "complete": v[4],
                    "ec": v[6] if len(v) > 6 else None}))
            else:
                print(json.dumps({"path": path, "type": "dir"}))
                walk(v[1], path)

    print(json.dumps({"image_seq": log.seq,
                      "next_block_id": snap["next_block_id"],
                      "gen_stamp": snap["gen_stamp"]}))
    walk(snap["tree"], "")
    return 0


def cmd_oev(args) -> int:
    """Offline edits viewer: dump WAL records as JSON lines
    (OfflineEditsViewer analog)."""
    from hdrf_tpu_torch.proto import rpc
    from hdrf_tpu_torch.utils import wal as walmod

    path = os.path.join(args.meta_dir, "edits.wal")
    for payload in walmod.recover(path, truncate=False):
        seq, *rec = rpc.unpackb(payload, raw=False, use_list=True)
        print(json.dumps({"seq": seq, "op": rec[0], "args": rec[1:]}))
    return 0


# ------------------------------------------------------------------ balancer

def cmd_balancer(args) -> int:
    """Move replicas from over- to under-utilized DNs until every node is
    within ``threshold`` of the mean (Balancer.java policy, simplified to
    block counts; the Dispatcher's move legs ride rpc_move_block)."""
    with _client(args) as c:
        for _ in range(args.iterations):
            report = [d for d in c.datanode_report() if d["alive"]]
            if len(report) < 2:
                print("not enough live datanodes")
                return 0
            mean = sum(d["blocks"] for d in report) / len(report)
            over = [d for d in report if d["blocks"] > mean + args.threshold]
            under = sorted((d for d in report
                            if d["blocks"] < mean - args.threshold),
                           key=lambda d: d["blocks"])
            if not over or not under:
                print(f"balanced: mean={mean:.1f} "
                      f"spread={[d['blocks'] for d in report]}")
                return 0
            moved = 0
            for src in over:
                blocks = c._call("datanode_blocks", dn_id=src["dn_id"],
                                    limit=args.batch)
                for bid in blocks:
                    dst = under[moved % len(under)]
                    if c._call("move_block", block_id=bid,
                                  from_dn=src["dn_id"], to_dn=dst["dn_id"]):
                        moved += 1
                    if moved >= args.batch:
                        break
                if moved >= args.batch:
                    break
            print(f"scheduled {moved} moves; waiting for settle")
            time.sleep(args.wait_s)
    return 0


def cmd_diskbalancer(args) -> int:
    """DiskBalancer-lite (server/diskbalancer analog): ask a DataNode to
    even its own volumes — plan + execute in one round trip."""
    r = _dn_call(args.datanode, "disk_balance", timeout=60.0,
                 threshold=args.threshold)
    print(json.dumps(r, indent=2))
    return 0


def cmd_mover(args) -> int:
    """Mover (server/mover/Mover.java:70 analog): migrate replicas until
    every block's storage types satisfy its path's effective policy.  The
    NN proposes (from, to) legs; each rides the same rpc_move_block the
    balancer uses (copy to target, invalidate source once reported)."""
    with _client(args) as c:
        total = 0
        for _ in range(args.iterations):
            moves = c._call("policy_violations", limit=args.batch)
            if not moves:
                print(f"storage policies satisfied ({total} moves)")
                return 0
            for mv in moves:
                if c._call("move_block", block_id=mv["block_id"],
                           from_dn=mv["from_dn"], to_dn=mv["to_dn"]):
                    total += 1
            print(f"scheduled {len(moves)} moves; waiting for settle")
            time.sleep(args.wait_s)
        print(f"iteration budget exhausted after {total} moves")
        return 1


# ---------------------------------------------------------------------- main

def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="hdrf")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("namenode")
    d.add_argument("--config", default=None)
    d.add_argument("--port", type=int, default=None)
    d.set_defaults(fn=cmd_namenode)

    d = sub.add_parser("datanode")
    d.add_argument("--config", default=None)
    d.add_argument("--namenode", required=True)
    d.add_argument("--secure", action="store_true")
    d.add_argument("--data-dir", default=None)
    d.set_defaults(fn=cmd_datanode)

    d = sub.add_parser("httpfs")
    d.add_argument("--namenode", required=True)
    d.add_argument("--secure", action="store_true")
    d.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    d.add_argument("--port", type=int, default=9870)
    d.set_defaults(fn=cmd_httpfs)

    d = sub.add_parser("dfs")
    d.add_argument("--namenode", required=True)
    d.add_argument("--secure", action="store_true")
    d.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    d.add_argument("--scheme", default=None)
    d.add_argument("--ec", default=None)
    d.set_defaults(fn=cmd_dfs, takes_ops=True)

    d = sub.add_parser("dfsadmin")
    d.add_argument("--namenode", required=True)
    d.add_argument("--secure", action="store_true")
    d.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    d.set_defaults(fn=cmd_dfsadmin, takes_ops=True)

    d = sub.add_parser("diskbalancer")
    d.add_argument("--datanode", required=True, help="host:port")
    d.add_argument("--threshold", type=float, default=0.10)
    d.set_defaults(fn=cmd_diskbalancer)

    d = sub.add_parser("storage")
    d.add_argument("action", choices=["version", "rollback", "finalize"])
    d.add_argument("directory")
    d.set_defaults(fn=cmd_storage)

    d = sub.add_parser("oiv")
    d.add_argument("meta_dir")
    d.set_defaults(fn=cmd_oiv)

    d = sub.add_parser("oev")
    d.add_argument("meta_dir")
    d.set_defaults(fn=cmd_oev)

    d = sub.add_parser("mover")
    d.add_argument("--namenode", required=True)
    d.add_argument("--secure", action="store_true")
    d.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    d.add_argument("--iterations", type=int, default=10)
    d.add_argument("--batch", type=int, default=16)
    d.add_argument("--wait-s", type=float, default=1.0)
    d.set_defaults(fn=cmd_mover)

    d = sub.add_parser("balancer")
    d.add_argument("--namenode", required=True)
    d.add_argument("--secure", action="store_true")
    d.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    d.add_argument("--threshold", type=float, default=2.0)
    d.add_argument("--iterations", type=int, default=10)
    d.add_argument("--batch", type=int, default=8)
    d.add_argument("--wait-s", type=float, default=2.0)
    d.set_defaults(fn=cmd_balancer)

    # dfs/dfsadmin ops are dash-prefixed like the reference shell (-ls,
    # -put, ...), which argparse (and its subparsers) won't accept — split
    # the command line at the first single-dash token and parse only the
    # prefix; everything from the op onward passes through verbatim.
    argv = list(sys.argv[1:] if argv is None else argv)
    op_args: list[str] = []
    if argv and argv[0] in ("dfs", "dfsadmin"):
        for i, tok in enumerate(argv[1:], start=1):
            if tok.startswith("-") and not tok.startswith("--"):
                argv, op_args = argv[:i], argv[i:]
                break
    args = p.parse_args(argv)
    if getattr(args, "takes_ops", False):
        if not op_args:
            p.error("missing operation")
        args.op, args.args = op_args[0], op_args[1:]
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
