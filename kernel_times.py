#!/usr/bin/env python3
"""Time the port's kernels of one checkout on one GPU: the CDC scan and
select, the scan's words-only mode (``be_image``), the shard scan,
SHA-256, the match deltas, the row sort, the Reed-Solomon kernel and the
raw lane gather.

    python3 kernel_times.py [--tree DIR] [--only cdc_scan,be_image,...]

Imports ``hdrf_tpu_torch`` from DIR (default: this checkout), builds its
kernels with its own build module (into DIR/build), and times them with
chip_smoke.py's helpers on the inputs chip_smoke.py makes with its
default seed and block size: the scan and the select on its five big
blocks (``TIMING cdc_scan`` and ``TIMING cdc_select`` lines; each scan
and select first held against its plain version, tolerance zero);
``be_image`` on the random 128 MiB block and a random 32 MiB container
(``TIMING be_image`` lines with the library call's time; a checkout
without the words-only mode runs the full scan); the shard scan on shard
1 of the random block at n_seq 4 and 8 (``TIMING shard_scan`` lines);
SHA-256 on the random, text and zeros blocks, each lane table alone and
both in one call (``TIMING sha256`` lines, digests sampled against
hashlib; a checkout without the grouped call runs the two tables as two
launches); ``match_deltas`` at strides 2 and 4 on the random, zeros,
text, source and sparse containers (``TIMING match_deltas`` lines, each
first held against its plain version); and ``sort_rows`` at each call
site of the match scan of the ``source`` container at stride 2
(``TIMING sort_rows`` lines; keys held against the plain sort); and the
GF(2^8) Reed-Solomon kernel at a 32 MiB container's stripe length, as
RS(6,3) encode, a decode of three data stripes, a two-survivor partial
sum, the encode with every row one byte past 16-byte alignment, and a
sweep of the RS(k, rows) encode matrices over k 1, 2, 3, 6, 10, 24 and
rows 1, 3, 8 (``TIMING rs`` lines, each held against its plain version;
a checkout without ``ops/rs_cuda.py`` has no such kernel and is
skipped); and the raw lane gather in both orders without the scheme: a
random 32 MiB container staged as the reconstructor stages it, cut at
``native.cdc_select`` cuts, one group a bucket padded to 128 lanes, and
one 128-lane group of 3 chunks (``TIMING gather_raw`` lines "container"
and "small"), then chip_smoke.py's ``reduce`` corpus written through the
scheme and the groups of two of its reads, block 0 and the one with the
most groups (a checkout without the byte-order mode times the words and
the ``flip`` its reconstructor ran, ``adapt_raw_order``).  ``--only``
times a subset.  The last line is one JSON object of the times.  Two checkouts timed in one call on one card compare their
kernels, e.g. an earlier commit unpacked with ``git archive`` into a
directory that .gitignore lists:

    python3 kernel_times.py --tree _archive/base && python3 kernel_times.py
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GROUPS = ("cdc_scan", "cdc_select", "be_image", "shard_scan", "sha256",
          "match_deltas", "sort_rows", "rs", "gather_raw")
RS_SWEEP_K = (1, 2, 3, 6, 10, 24)
RS_SWEEP_ROWS = (1, 3, 8)
SMALL_GROUP = 3          # real lanes of the one-group read (128 lanes)


def adapt_raw_order(cs) -> None:
    """Give a checkout whose ``gather_lanes_raw`` has no byte-order mode
    one, as its reconstructor took the bytes: the words, then each
    word's bytes reversed with ``torch.flip`` (u8[L, W, 4])."""
    gc = cs.gather_cuda
    if "order" in inspect.signature(gc.gather_lanes_raw).parameters:
        return
    words = gc.gather_lanes_raw

    def gather_lanes_raw(img, ol, bucket, order="words"):
        lanes = words(img, ol, bucket)
        if order == "words":
            return lanes
        return lanes.view(cs.torch.uint8).view(lanes.shape[0], -1, 4).flip(-1)
    gc.gather_lanes_raw = gather_lanes_raw


def time_scheme_gather(cs, cdc) -> list:
    """``gather_raw`` at the shapes of chip_smoke.py's scheme reads: its
    ``reduce`` corpus written through the tree's ``dedup_lz4`` scheme
    (``scheme_context``, ``scheme_write``), then block 0's read and the
    read with the most (container, bucket) groups (``time_gather_raw``)."""
    import tempfile

    blocks = cs.main_path_corpus(0, 8, 128)
    want = [cs.oracle(b, cdc) for b in blocks]
    with tempfile.TemporaryDirectory(prefix="kernel_times_") as root:
        ctx = cs.scheme_context(root, {})
        try:
            cs.scheme_write(ctx, blocks, want)
            return cs.time_gather_raw(ctx, blocks)
        finally:
            ctx.read_plane.close()
            ctx.index.close()


def time_container_gather(cs, dev, cdc) -> list:
    """``gather_raw`` without the scheme: a random 32 MiB container
    staged as the reconstructor stages it (its headroom, ``be_image``),
    cut at ``native.cdc_select`` cuts, one group a bucket padded to 128
    lanes as ``DeviceReconstructor.gather`` does (``TIMING gather_raw``
    "container"), and one small group: the first 3 chunks of the
    container's most common bucket in 128 lanes ("small")."""
    from hdrf_tpu_torch.ops import reconstruct

    a = np.random.default_rng(5).integers(0, 256, cs.SEAL_BYTES,
                                          dtype=np.uint8)
    img, _ = reconstruct.DeviceReconstructor(device=dev)._stage(a)
    cuts = cs.native.cdc_select(cs.native.gear_candidates(
        a, cs.gear_mask(cdc)), a.size, cdc.min_chunk, cdc.max_chunk)
    starts = np.concatenate([[0], cuts[:-1]])
    groups: dict = {}
    for off, ln in zip(starts.tolist(), (cuts - starts).tolist()):
        b = reconstruct._bucket_of(-(-ln // 64) + 1)
        groups.setdefault((0, b), []).append(off)
    common = max(groups, key=lambda g: len(groups[g]))
    rows = []
    for tag, gs in (("container", groups),
                    ("small", {common: groups[common][:SMALL_GROUP]})):
        calls, nbytes, lanes = cs.raw_calls(gs, lambda _: img)
        rows.append(cs.time_raw(tag, calls, nbytes, lanes,
                                chunks=sum(map(len, gs.values()))))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kernel_times")
    p.add_argument("--tree", default=str(ROOT),
                   help="the checkout whose hdrf_tpu_torch is timed")
    p.add_argument("--only", default=",".join(GROUPS),
                   help="comma-separated kernels to time, of "
                        + ", ".join(GROUPS))
    args = p.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        p.error(f"--only: unknown {sorted(only - set(GROUPS))}")
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(ROOT)]   # the package from DIR
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    try:
        pkg = Path(cs.cdc_cuda.__file__).resolve()
        cs.check(tree in pkg.parents, f"imported {pkg}, not {tree}'s package")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        cs._build.library()
        errs = {k: 0 for k in cs.KERNELS}
        cdc = cs.CdcConfig()
        mask, mn, mx = cs.gear_mask(cdc), cdc.min_chunk, cdc.max_chunk
        chain = (cs.sha256_cuda.chain_probe(dev)
                 if hasattr(cs.sha256_cuda, "chain_probe") else None)
        out = {"tree": str(tree), "card": cs.nvidia_smi(),
               "sha_chain_probe": chain, "cdc_scan": {}, "cdc_select": {},
               "be_image": {}, "shard_scan": [], "sha256": {},
               "match_deltas": [], "sort_rows": {}, "rs": {},
               "gather_raw": []}
        for name, a in cs.big_blocks(0, 128 * cs.MIB, mask):
            if not only & {"cdc_scan", "cdc_select", "sha256", "be_image",
                           "shard_scan"}:
                break
            c = cs.cdc_phase(name, a, mask, mn, mx, dev, errs)
            if "cdc_scan" in only:
                out["cdc_scan"][name] = cs.time_scan(name, c, mask, mn)
            if "cdc_select" in only:
                out["cdc_select"][name] = cs.time_select(name, c, mn, mx)
            if "sha256" in only and name in cs.SHA_TIMED:
                out["sha256"][name] = cs.time_sha(name, a, c, mask, mx, chain)
            if name == "random-block" and "be_image" in only:
                out["be_image"][name] = cs.time_image(name, c.block)
            if name == "random-block" and "shard_scan" in only:
                for n_seq in (4, 8):   # shard 1, its halo shard 0's tail
                    m = c.block.numel() // n_seq
                    out["shard_scan"].append(cs.time_shard(
                        name, c.block[m:2 * m], c.block[m - 31:m], m, mask,
                        n_seq))
            del a, c
        torch.cuda.empty_cache()
        # chip_smoke.py's containers (the chunks kind is not timed)
        corpora = (cs.seal_corpora(0, np.zeros(1, np.uint8))
                   if only & {"be_image", "match_deltas"} else {})
        if "be_image" in only:
            block = torch.from_numpy(corpora[cs.IMAGE_TIMED].copy()).to(dev)
            out["be_image"][cs.IMAGE_TIMED] = cs.time_image(cs.IMAGE_TIMED,
                                                            block)
            del block
        for name in cs.MATCH_TIMED:
            if "match_deltas" not in only:
                break
            block = torch.from_numpy(corpora[name].copy()).to(dev)
            for stride in (2, 4):
                vals, pos_bits = cs.lz4_device.entries(block, stride)
                e = cs.max_err(
                    cs.sort_cuda.match_deltas(vals, stride, pos_bits),
                    cs.sort_cuda.match_deltas_plain(vals, stride, pos_bits))
                cs.check(e == 0, f"match_deltas {name} stride {stride}: "
                                 f"kernel != plain (max err {e})")
                out["match_deltas"].append(
                    cs.time_match(name, stride, vals, pos_bits))
            del block, vals
        del corpora
        torch.cuda.empty_cache()
        if "rs" in only and (tree / "hdrf_tpu_torch/ops/rs_cuda.py").exists():
            from hdrf_tpu_torch.ops import rs
            L, k, m = cs.RS_LENGTHS[-1], cs.EC_K, cs.EC_M
            enc = rs.rs_matrix(k, m)[k:]
            for name, c, off in (
                    ("encode", enc, 0),
                    ("decode", rs.repair_rows(k, m, (3, 4, 5, 6, 7, 8),
                                              (0, 1, 2)), 0),
                    ("partial_sums", rs.repair_rows(
                        k, m, (0, 2, 3, 5, 6, 8), (1, 4, 7))[:, [1, 4]], 0),
                    ("encode_offset1", enc, 1),
                    *((f"k{kk}_rows{r}", rs.rs_matrix(kk, r)[kk:], 0)
                      for kk in RS_SWEEP_K for r in RS_SWEEP_ROWS)):
                out["rs"][name] = cs.time_rs(name, c, L, dev, offset=off)
        if "gather_raw" in only:
            adapt_raw_order(cs)
            out["gather_raw"] = (time_container_gather(cs, dev, cdc)
                                 + time_scheme_gather(cs, cdc))
        if "sort_rows" not in only:
            print(json.dumps(out), flush=True)
            return 0
        block = torch.from_numpy(cs.source_container(cs.SEAL_BYTES)).to(dev)
        shapes = cs.lz4_device.DeviceLz4(stride=2, device=dev)._shapes(
            block.numel())
        calls, _ = cs.captured_sorts(block, 2, shapes)
        for site, (key, vs, kw) in zip(cs.SORT_SITES, calls):
            got = cs.sort_cuda.sort_rows(key, *vs, **kw)
            want = cs.sort_cuda.sort_rows_plain(key, *vs, **kw)
            e = cs.max_err(got[0], want[0])
            cs.check(e == 0, f"sort_rows {site}: keys != plain (max err {e})")
            out["sort_rows"][site] = cs.time_sort_site(site, key, vs, kw)
    except cs.SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
