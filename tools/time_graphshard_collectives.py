"""Time the graph-sharding collectives' forms over gloo on one card.

    python tools/time_graphshard_collectives.py [--rows 4000] [--reps 10]

Starts two ranks of itself on cuda:0 in a gloo group (NCCL refuses two
ranks on one device) and times, in turns (A, B, B, A, ...), each way
the sharded forward could move its rows at the shapes of
``chip_smoke.py`` [graphshard]'s 8,000-atom step (``--rows`` rows a rank,
32 and 3 features, f32): all-gather and reduce-scatter in their list and
tensor forms, each on the CUDA tensor and staged through the host, and
the ring shift by ``batch_isend_irecv`` through the host (gloo's
send/receive take no CUDA tensor). Each time is host ms around the call
with the device synchronized before and after, as
``parallel/graphshard``'s collective clock takes it. Prints the card's
name and power limit and one JSON line: median ms per (form, features).
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist


def _forms(rank, world, rows, feat):
    dev = torch.device("cuda", 0)
    x = torch.randn(rows, feat, device=dev) + rank
    big = torch.randn(world * rows, feat, device=dev) + rank

    def ag_list(t):
        out = t.new_empty((world * rows, feat))
        dist.all_gather(list(out.chunk(world)), t)
        return out

    def ag_tensor(t):
        out = t.new_empty((world * rows, feat))
        dist.all_gather_into_tensor(out, t)
        return out

    def rs_list(t):
        out = t.new_empty((rows, feat))
        dist.reduce_scatter(out, list(t.chunk(world)))
        return out

    def rs_tensor(t):
        out = t.new_empty((rows, feat))
        dist.reduce_scatter_tensor(out, t)
        return out

    def shift(t):
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, (rank + 1) % world),
               dist.P2POp(dist.irecv, out, (rank - 1) % world)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return out

    def host(fn):
        return lambda t: fn(t.cpu()).to(dev)

    return {
        "all_gather list": (ag_list, x), "all_gather tensor": (ag_tensor, x),
        "all_gather list via host": (host(ag_list), x),
        "all_gather tensor via host": (host(ag_tensor), x),
        "reduce_scatter list": (rs_list, big), "reduce_scatter tensor": (rs_tensor, big),
        "reduce_scatter list via host": (host(rs_list), big),
        "reduce_scatter tensor via host": (host(rs_tensor), big),
        "shift via host": (host(shift), x),
    }


def rank_main(rank, world, work, rows, reps):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, "store"), world),
                            rank=rank, world_size=world)
    times = {}
    for feat in (32, 3):
        forms = _forms(rank, world, rows, feat)
        names = sorted(forms)
        for name in names:  # warm-up
            forms[name][0](forms[name][1])
        for rep in range(reps):
            for name in names if rep % 2 == 0 else reversed(names):
                fn, arg = forms[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(arg)
                torch.cuda.synchronize()
                times.setdefault(f"{name}, F = {feat}", []).append(
                    (time.perf_counter() - t0) * 1e3)
    if rank == 0:
        with open(os.path.join(work, "times.json"), "w") as f:
            json.dump(times, f)
    dist.destroy_process_group()


def main():
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), 2, sys.argv[3], int(sys.argv[4]), int(sys.argv[5]))
        return
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=4000)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_graphshard_collectives: no CUDA device")
    work = tempfile.mkdtemp(prefix="gs_collectives_")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), work,
                               str(args.rows), str(args.reps)]) for r in range(2)]
    rcs = [p.wait(timeout=600) for p in procs]
    if any(rcs):
        sys.exit(f"ranks exited {rcs}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    times = json.load(open(os.path.join(work, "times.json")))
    print(card)
    print(json.dumps({"rows": args.rows, "reps": args.reps, "median_ms": {
        k: round(statistics.median(v), 4) for k, v in sorted(times.items())}}))


if __name__ == "__main__":
    main()
