#!/usr/bin/env python3
"""Time the CDC select, SHA-256, the match deltas and the row sort of one
checkout's port on one GPU.

    python3 kernel_times.py [--tree DIR]

Imports ``hdrf_tpu_torch`` from DIR (default: this checkout), builds its
kernels with its own build module (into DIR/build), and times them with
chip_smoke.py's helpers on the inputs chip_smoke.py makes with its
default seed and block size: the select on its five big blocks
(``TIMING cdc_select`` lines; each select first held against its plain
version, tolerance zero); SHA-256 on the random, text and zeros blocks,
each lane table alone and both in one call (``TIMING sha256`` lines,
digests sampled against hashlib; a checkout without the grouped call
runs the two tables as two launches); ``match_deltas`` at strides 2 and
4 on the random, zeros, text, source and sparse containers (``TIMING
match_deltas`` lines, each first held against its plain version); and
``sort_rows`` at each call site of the match scan of the ``source``
container at stride 2 (``TIMING sort_rows`` lines; keys held against the
plain sort).  The last line is one JSON object of the times.  Two checkouts timed in one call on one
card compare their kernels, e.g. an earlier commit unpacked with ``git
archive`` into a directory that .gitignore lists:

    python3 kernel_times.py --tree _archive/base && python3 kernel_times.py
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kernel_times")
    p.add_argument("--tree", default=str(ROOT),
                   help="the checkout whose hdrf_tpu_torch is timed")
    args = p.parse_args(argv)
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
               "sha_chain_probe": chain, "cdc_select": {}, "sha256": {},
               "match_deltas": [], "sort_rows": {}}
        for name, a in cs.big_blocks(0, 128 * cs.MIB, mask):
            c = cs.cdc_phase(name, a, mask, mn, mx, dev, errs)
            out["cdc_select"][name] = cs.time_select(name, c, mn, mx)
            if name in cs.SHA_TIMED:
                out["sha256"][name] = cs.time_sha(name, a, c, mask, mx, chain)
            del a, c
        torch.cuda.empty_cache()
        # chip_smoke.py's containers (the chunks kind is not timed)
        corpora = cs.seal_corpora(0, np.zeros(1, np.uint8))
        for name in cs.MATCH_TIMED:
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
