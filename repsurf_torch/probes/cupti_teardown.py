"""Probe: how often a torch.profiler trace records no device time over
many traces in one process, with CUPTI torn down at the end of each trace
(torch's default) and kept up (TEARDOWN_CUPTI=0).
Each trace covers 5 calls of FPS and brute kNN (this repo's kernels) and a
matmul and sort; each mode runs in a process of its own for at most 60 s,
and the two modes alternate twice.  Prints one JSON line a process.

Usage, from the root of the repo on a machine with a GPU:
    python3 repsurf_torch/probes/cupti_teardown.py"""
import glob
import json
import os
import subprocess
import sys
import time
from pathlib import Path

TRACES, SECONDS = 600, 60


def child(n):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repsurf_torch.ops.kernels.fps import fps
    from repsurf_torch.ops.kernels.knn import knn_brute

    dev = torch.device("cuda", 0)
    xyz = torch.rand((2, 5000, 3), generator=torch.Generator(dev).manual_seed(0), device=dev)
    a = torch.rand((512, 512), device=dev)

    def fn():
        i = fps(xyz, 1250)
        q = torch.gather(xyz, 1, i.long()[..., None].expand(-1, -1, 3))
        knn_brute(32, xyz, q)
        (a @ a).sort(dim=1)

    fn()
    torch.cuda.synchronize()
    empty, t0 = [], time.perf_counter()
    for c in range(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        if sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()) <= 0:
            empty.append(c)
        if time.perf_counter() - t0 > SECONDS:
            n = c + 1
            break
    print(json.dumps({"TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI"), "traces": n,
                      "empty": len(empty), "first_empty": empty[:10],
                      "s_per_trace": (time.perf_counter() - t0) / n}), flush=True)


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from repsurf_torch.ops.kernels import build

    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    for lib in glob.glob(os.path.join(os.path.dirname(torch.__file__), "lib", "*.so*")):
        hits = subprocess.run(["grep", "-c", "-a", "TEARDOWN_CUPTI", lib], capture_output=True,
                              text=True).stdout.strip()
        if hits not in ("", "0"):
            print(f"  TEARDOWN_CUPTI named in {os.path.basename(lib)}", flush=True)
    build.build()
    build.library()
    for mode in (None, "0", None, "0"):
        env = dict(os.environ)
        env.pop("TEARDOWN_CUPTI", None)
        if mode is not None:
            env["TEARDOWN_CUPTI"] = mode
        r = subprocess.run([sys.executable, __file__, str(TRACES)], env=env, capture_output=True,
                           text=True, timeout=SECONDS + 90)
        errors = [ln for ln in r.stderr.splitlines() if "warn" not in ln.lower()]
        print(f"rc {r.returncode}: {r.stdout.strip()[-600:]}", flush=True)
        for ln in errors[-10:]:
            print(f"  stderr: {ln}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        child(int(sys.argv[1]))
    else:
        main()
