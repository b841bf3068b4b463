#!/usr/bin/env python3
"""Time the port's kernels of one checkout on one GPU: the CDC scan and
select, the scan's words-only mode (``be_image``), the shard scan,
SHA-256, the match deltas, the row sort and the Reed-Solomon kernel.

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
RS(6,3) encode, a decode of three data stripes and a two-survivor
partial sum (``TIMING rs`` lines, each held against its plain version;
a checkout without ``ops/rs_cuda.py`` has no such kernel and is
skipped).  ``--only`` times a subset.  The last line is one JSON object
of the times.  Two checkouts timed in one call on one card compare their
kernels, e.g. an earlier commit unpacked with ``git archive`` into a
directory that .gitignore lists:

    python3 kernel_times.py --tree _archive/base && python3 kernel_times.py
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GROUPS = ("cdc_scan", "cdc_select", "be_image", "shard_scan", "sha256",
          "match_deltas", "sort_rows", "rs")


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
               "match_deltas": [], "sort_rows": {}, "rs": {}}
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
            for name, c in (
                    ("encode", rs.rs_matrix(k, m)[k:]),
                    ("decode", rs.repair_rows(k, m, (3, 4, 5, 6, 7, 8),
                                              (0, 1, 2))),
                    ("partial_sums", rs.repair_rows(
                        k, m, (0, 2, 3, 5, 6, 8), (1, 4, 7))[:, [1, 4]])):
                out["rs"][name] = cs.time_rs(name, c, L, dev)
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
