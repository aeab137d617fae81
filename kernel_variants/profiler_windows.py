#!/usr/bin/env python3
"""How many device events a torch.profiler window loses, on one NVIDIA
card (H100), with the window's old guard and with chip_smoke.py's.

    python3 kernel_variants/profiler_windows.py [--windows 150] [--out record.json]

Times one lone short kernel, as chip_smoke.py times K2's library call:
torch.searchsorted of 511 queries over 471,633 sorted int32 tile ids,
50 calls a window. The old guard opened a window with a spin kernel, a
sync and a 2 ms wait; chip_smoke.py's (``profile_device``) does that at
both ends with a 10 ms wait. For each, the number of windows whose
searchsorted events came to fewer than the 50 calls, and the counts seen.
Needs the card; exits 1 without one.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

REPS = 50


def old_profile_device(fn, reps: int):
    """chip_smoke.profile_device before its guard at the window's end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        time.sleep(0.002)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return 0.0, [(e.key, e.self_device_time_total, e.count)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0 and cs.SPIN not in e.key]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=150)
    ap.add_argument("--out", default="", help="also write the record here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    g = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.sort(torch.randint(0, 511, (471633,), device="cuda",
                                   generator=g, dtype=torch.int32)).values
    q = torch.arange(511, dtype=torch.int32, device="cuda")

    def fn():
        return torch.searchsorted(ids, q, out_int32=True)

    record = {}
    for label, pd in (("old guard", old_profile_device),
                      ("chip_smoke.profile_device", cs.profile_device)):
        counts = []
        t0 = time.perf_counter()
        for _ in range(args.windows):
            _, rows = pd(fn, REPS)
            counts.append(sum(n for k, _, n in rows if "searchsorted" in k))
        record[label] = {
            "windows": len(counts), "short": sum(c < REPS for c in counts),
            "events_seen": {c: counts.count(c) for c in sorted(set(counts))},
            "s": time.perf_counter() - t0}
        print(label, record[label], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
