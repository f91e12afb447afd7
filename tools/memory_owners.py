#!/usr/bin/env python3
"""What holds the card's memory in ``chip_smoke.py``'s main process after
its phases 3-8 (a diagnostic run by hand on a GPU).

    python3 tools/memory_owners.py

Builds the kernels and runs phases 3-8 as ``chip_smoke.py`` runs them
(phase 3's losses are what phases 4 and 8 are held to), empties the
caching allocator, then prints one JSON line (also written to
chiprun_out/memory_owners.json): the card's name and power limit, the
GB allocated and reserved, and ``memory_owners()``'s reading of who
holds them.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def memory_owners(top=10):
    """What holds this process's card memory: the live CUDA tensors that
    gc finds (their distinct storages' bytes; the largest storages by
    shape and dtype, with the types of the objects that refer to them
    and of those objects' referrers) against the allocator's allocated
    bytes, and the allocator's segments by memory pool (a CUDA graph's
    private pool, or the default one) and stream."""
    import torch
    gc.collect()
    storages = {}
    for o in gc.get_objects():
        if torch.is_tensor(o) and o.is_cuda:
            st = o.untyped_storage()
            storages.setdefault(st.data_ptr(), (st.nbytes(), o))
    largest = sorted(storages.values(), key=lambda v: -v[0])[:top]
    # this function's own references are not owners
    mine = {id(storages), id(largest)} | {id(v) for v in storages.values()}

    def kinds(obj, depth):
        out = []
        for r in gc.get_referrers(obj):
            if id(r) in mine or isinstance(r, type(sys._getframe())):
                continue
            name = type(r).__name__
            if depth and isinstance(r, (dict, list, tuple)):
                name += "<-" + "|".join(sorted(set(kinds(r, depth - 1))))
            out.append(name)
        return out
    pools = {}
    for seg in torch.cuda.memory_snapshot():
        key = f"pool {seg.get('segment_pool_id')} stream {seg.get('stream')}"
        p = pools.setdefault(key, {"segments": 0, "total": 0,
                                   "allocated": 0, "active": 0})
        p["segments"] += 1
        p["total"] += seg.get("total_size", 0)
        p["allocated"] += seg.get("allocated_size", 0)
        p["active"] += seg.get("active_size", 0)
    stats = torch.cuda.memory_stats()
    return {
        "gc_tensor_storages": len(storages),
        "gc_tensor_bytes": sum(v[0] for v in storages.values()),
        "allocated_bytes": stats.get("allocated_bytes.all.current"),
        "reserved_bytes": stats.get("reserved_bytes.all.current"),
        "largest": [{"bytes": b, "shape": list(t.shape),
                     "dtype": str(t.dtype),
                     "referrers": sorted(set(kinds(t, 2)))}
                    for b, t in largest],
        "pools": pools}


def main():
    import torch
    if not torch.cuda.is_available():
        print("memory_owners: needs a GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.build_all()
    coll_losses = cs.collective_phase()[0]
    cs.ps_phase(coll_losses)
    cs.resnet_phase()
    cs.bert_phase()
    cs.llama_phase()
    cs.launch_phase(coll_losses)
    torch.cuda.empty_cache()
    out = {"device": smi,
           "held_gb": {"allocated": torch.cuda.memory_allocated() / 1e9,
                       "reserved": torch.cuda.memory_reserved() / 1e9},
           "owners": memory_owners()}
    line = json.dumps(out)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "memory_owners.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
